"""K3, the masked consistent-mass apply (``cuda_kernels.mass_apply``) in
plain mode or as one step of the B^-1 semi-iteration: bytes of one
launch (it is bound by bytes; its operations are 12 per row entry and
column, far under the f32 rate's share).

Each (D, L) f32 block the launch needs is read or written once: plain
mode (and a step that is first and last) X in, Y out; a first step also
writes R and Z, a last step reads them, a middle step reads and writes
both. Tables read once: DOFs (E, 6) int32, weights (E, Q), the shape
table (Q, 6), the mask (D,), in step mode the Jacobi scale (D,).
"""

KERNEL = "mass_apply_kernel"
WRAPS = "pl_fem_tpu_torch.ops.cuda_kernels.mass_apply"


def count(D: int, E: int, Q: int, L: int, blocks: int = 2, step=False):
    """(bytes, f32 operations) of one launch touching ``blocks`` (D, L)
    blocks."""
    nbytes = (blocks * 4 * D * L + 4 * (E * 6 + E * Q + Q * 6 + D)
              + (4 * D if step else 0))
    return nbytes, 0


def blocks_of(step) -> int:
    if step is None or (step.first and step.last):
        return 2
    if step.first or step.last:
        return 4
    return 6


def work(X, gs, w, N, mask, park=1.0, step=None):
    D, L = X.shape
    E, Q = w.shape
    return count(D, E, Q, L, blocks_of(step), step is not None)
