"""Launches of the filter's kernels over the window, per design: the
``.launches`` counters of K1 (``apply_vector3``) or K5
(``apply_stacked``), K3 (``mass_apply``), K4 (``cheb_step``) and K10
(``ritz_residual``). A count: it repeats exactly at a fixed seed."""

COUNTERS = (
    "pl_fem_tpu_torch.ops.cuda_kernels.apply_vector3",
    "pl_fem_tpu_torch.ops.cuda_kernels.apply_stacked",
    "pl_fem_tpu_torch.ops.cuda_kernels.mass_apply",
    "pl_fem_tpu_torch.ops.triton_kernels.cheb_step",
    "pl_fem_tpu_torch.ops.cuda_kernels.ritz_residual",
)


def read(win):
    if not win.designs:
        return None
    return sum(win.counters[c] for c in COUNTERS) / win.designs
