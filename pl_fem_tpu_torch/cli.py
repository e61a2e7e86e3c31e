"""Command-line dataset generation (reference seam: main.py:307-427).

    python -m pl_fem_tpu_torch.cli --n 500 --out ./dataset [--no-pml]
        [--scalar] [--cauchy] [--cmt-slices 5] [--seed 42]
        [--config run.yaml] [--verbose]

Port of pl_fem_tpu/cli.py with the same flags. The mode solves run on
``SolverConfig.device`` (default ``cuda``; a config file's
``simulation: {solver: {device: cpu}}`` runs them on the CPU). Differences
vs the reference CLI (documented, deliberate):

- samples come from the seeded stratified LHS (SmartSampler) instead of
  plain random draws (main.py:327-340), so runs are reproducible;
- records checkpoint incrementally to records.jsonl and runs resume
  after a crash (the reference writes CSV only at the end);
- the vectorial H-field solver is the default (use --scalar for the
  reference CLI's scalar pipeline, which runs design by design).
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

STAT_COLUMNS = ("IL_phys_mux_dB", "MDL_phys_mux_dB", "PDL_mux_dB")


def setup_logger(level=logging.INFO, log_file=None):
    root = logging.getLogger("pl_fem_tpu_torch")
    root.setLevel(level)
    root.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                            datefmt="%H:%M:%S")
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(fmt)
    root.addHandler(console)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def _parse_with_config(parser, argv):
    """Two-stage parse: --config file values become argument defaults
    (explicit command-line flags still win), and the file's
    ``simulation`` sub-dict is returned for SimulationConfig."""
    pre, _ = parser.parse_known_args(argv)
    sim_overrides = {}
    if pre.config:
        from .config import load_config_file

        data = load_config_file(pre.config)
        sim_overrides = data.pop("simulation", {}) or {}
        known = {a.dest for a in parser._actions}
        unknown = set(data) - known
        if unknown:
            parser.error(f"unknown config file keys: {sorted(unknown)}")
        parser.set_defaults(**data)
    return parser.parse_args(argv), sim_overrides


DESCRIBE_ROWS = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")


def describe_stats(records, columns=STAT_COLUMNS):
    """{column: [count, mean, std, min, 25%, 50%, 75%, max]}: what
    ``pandas.DataFrame.describe`` computes (sample std, linear
    quartiles; missing values skipped)."""
    stats = {}
    for c in columns:
        v = np.array([getattr(r, c) for r in records
                      if getattr(r, c) is not None], dtype=np.float64)
        v = v[~np.isnan(v)]
        if v.size == 0:
            stats[c] = [0.0] + [np.nan] * 7
            continue
        std = float(np.std(v, ddof=1)) if v.size > 1 else np.nan
        stats[c] = [float(v.size), float(v.mean()), std, float(v.min()),
                    *map(float, np.percentile(v, [25, 50, 75])),
                    float(v.max())]
    return stats


def describe(records, columns=STAT_COLUMNS) -> str:
    """The :func:`describe_stats` table as text, one row per statistic."""
    stats = describe_stats(records, columns)
    width = max(len(c) for c in columns) + 2
    lines = [" " * 6 + "".join(f"{c:>{width}}" for c in columns)]
    for i, name in enumerate(DESCRIBE_ROWS):
        lines.append(f"{name:<6}" + "".join(
            f"{stats[c][i]:>{width}.6f}" for c in columns))
    return "\n".join(lines)


def generator(argv=None):
    """Parse ``argv`` and set up its run: the logger (into
    ``<out>/run.log``) and the DatasetGenerator. Returns
    ``(generator, args)``."""
    parser = argparse.ArgumentParser(
        description="Generate a photonic-lantern dataset "
                    "(modes + losses + CMT)")
    parser.add_argument("--n", type=int, default=20,
                        help="number of samples")
    parser.add_argument("--out", type=str, default="./dataset_pl")
    parser.add_argument("--no-pml", action="store_true", default=False)
    parser.add_argument("--scalar", action="store_true", default=False,
                        help="scalar Helmholtz instead of vectorial H-field")
    parser.add_argument("--cauchy", action="store_true", default=False,
                        help="IP-Dip Cauchy dispersion n(lambda)")
    parser.add_argument("--cmt-slices", type=int, default=0,
                        help=">=2 enables CMT over that many taper slices")
    parser.add_argument("--engine", choices=("serial", "sweep"),
                        default="sweep",
                        help="'sweep' batches designs through canonical-"
                             "grid packed sweeps on the device; 'serial' is "
                             "the reference-style per-design loop")
    parser.add_argument("--quality-threshold", type=float, default=0.35)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--mesh-min-points", type=int, default=None)
    parser.add_argument("--no-resume", action="store_true", default=False)
    parser.add_argument("--adaptive-rounds", type=int, default=0,
                        help=">=2 runs the exploit/explore adaptive-"
                             "sampling loop over that many rounds "
                             "instead of one stratified LHS batch")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config file (needs PyYAML): top-level "
                             "keys are CLI defaults (n, out, engine, ...); "
                             "the 'simulation' sub-dict maps onto "
                             "SimulationConfig/SolverConfig/MeshConfig "
                             "(reference seam: README.md:216)")
    parser.add_argument("--verbose", action="store_true")
    args, sim_overrides = _parse_with_config(parser, argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = setup_logger(
        logging.DEBUG if args.verbose else logging.INFO,
        out_dir / "run.log")

    import dataclasses

    from .config import SimulationConfig, simulation_config_from_dict
    from .dataset import DatasetGenerator

    if sim_overrides:
        sim_overrides.setdefault("use_pml", not args.no_pml)
        cfg = simulation_config_from_dict(sim_overrides)
    else:
        cfg = SimulationConfig(use_pml=not args.no_pml)
    if args.mesh_min_points:
        cfg = dataclasses.replace(cfg, mesh_min_points=args.mesh_min_points,
                                  mesh_target_points=2 * args.mesh_min_points)

    logger.info("=== pl_fem_tpu_torch dataset generation ===")
    logger.info("samples=%d out=%s pml=%s solver=%s device=%s", args.n,
                out_dir.absolute(), not args.no_pml,
                "scalar" if args.scalar else "vectorial", cfg.solver.device)

    gen = DatasetGenerator(
        config=cfg,
        use_vectorial=not args.scalar,
        use_cauchy_dispersion=args.cauchy,
        n_taper_slices=args.cmt_slices,
        base_seed=args.seed,
        out_dir=out_dir,
    )
    return gen, args


def run(argv=None):
    """Parse ``argv``, generate the dataset, log its statistics; return
    ``(generator, records)``. :func:`main` is this with exit code 0."""
    gen, args = generator(argv)
    logger = logging.getLogger("pl_fem_tpu_torch")
    if args.adaptive_rounds >= 2:
        records = gen.generate_adaptive(
            args.n, n_rounds=args.adaptive_rounds,
            quality_threshold=args.quality_threshold,
            resume=not args.no_resume, engine=args.engine)
    else:
        records = gen.generate(args.n,
                               quality_threshold=args.quality_threshold,
                               resume=not args.no_resume,
                               engine=args.engine)

    n_ok = sum(1 for r in records if r.success)
    logger.info("done: %d/%d successful", n_ok, len(records))
    valid = gen.physical_filter(records)
    logger.info("physical filter: %d records in [0.3, 10] dB IL window",
                len(valid))
    if valid:
        logger.info("dataset statistics:\n%s", describe(valid))
    logger.info("phase seconds, summed over designs: %s", " ".join(
        f"{k}={v:.2f}" for k, v in gen.phase_times.items()))
    return gen, records


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
