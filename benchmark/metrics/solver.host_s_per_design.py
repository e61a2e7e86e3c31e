"""Host float64 seconds per design: the program's host-only phases
(vectorial ``last_sweep_times``: host_family, polish, postproc; scalar
``last_solve_times``: host_build, polish, postproc, cascade) summed over
the window's requests, over the designs completed."""

HOST_PHASES = ("host_family", "polish", "postproc", "host_build", "cascade")


def read(win):
    if not win.designs:
        return None
    return win.phase_sum(HOST_PHASES) / win.designs
