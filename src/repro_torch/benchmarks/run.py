"""Benchmark runner of the port (port of ``benchmarks/run.py``): one
module per paper table/figure ported so far, plus the datapath matmul's
benchmark.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        [--smoke] [--only MOD ...] [--progress] [--device cuda|cpu]

Each benchmark runs in a subprocess, with ``--device`` passed to its
``__main__`` (``cuda``, the default, runs the kernels; ``cpu`` their
plain versions).  Output: CSV blocks, plus machine-readable
``BENCH_smla_sweep_torch.json`` from the paper figures.  `--smoke` (or
SMLA_SMOKE=1) shrinks horizons/trace lengths; the runner exits non-zero
if any module fails either way.
"""
import argparse
import os
import subprocess
import sys
import time

BENCHES = [
    "repro_torch.benchmarks.paper_table1",      # Table 1 / Fig 10 energy model
    "repro_torch.benchmarks.paper_table2",      # Table 2 configurations
    "repro_torch.benchmarks.paper_fig11",       # single-core perf/energy
    "repro_torch.benchmarks.paper_fig12",       # multi-core ws + energy
    "repro_torch.benchmarks.paper_fig13",       # layer count 2/4/8
    "repro_torch.benchmarks.paper_fig14",       # MPKI vs energy
    "repro_torch.benchmarks.paper_fig_policy",  # controller-policy sensitivity
    "repro_torch.benchmarks.paper_fig_ooo",     # OoO window depth x OooSelect
    "repro_torch.benchmarks.paper_fig_refresh", # refresh / deep power states
    "repro_torch.benchmarks.paper_fig_fault",   # fault injection / degradation
    "repro_torch.benchmarks.paper_fig_serve",   # serving traffic x org x policy
    "repro_torch.benchmarks.paper_fig_scale",   # sweep-engine scaling
    "repro_torch.benchmarks.smla_pipe_bench",   # SMLA pipeline kernel
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny horizons/sizes for CI (sets SMLA_SMOKE=1)")
    ap.add_argument("--only", nargs="*", metavar="MOD",
                    help="run only these modules (suffix match)")
    ap.add_argument("--progress", action="store_true",
                    help="per-bucket sweep progress lines, streamed as "
                         "each module runs (sets SMLA_PROGRESS=1; see "
                         "_util.progress_printer)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="passed to every module (default: cuda)")
    args = ap.parse_args(argv)

    env = dict(os.environ)
    if args.smoke:
        env["SMLA_SMOKE"] = "1"
    if args.progress:
        env["SMLA_PROGRESS"] = "1"
    # `-m repro_torch.benchmarks.X` from any cwd: src/ only
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src
    benches = [m for m in BENCHES
               if not args.only or any(m.endswith(o) for o in args.only)]
    if args.only and not benches:
        print(f"no benchmark matches {args.only}; available: "
              + " ".join(m.rsplit('.', 1)[1] for m in BENCHES),
              file=sys.stderr)
        return 2

    failed: list[tuple[str, int]] = []
    for mod in benches:
        print(f"\n===== {mod} =====", flush=True)
        t0 = time.time()
        # --progress streams the child (per-bucket lines land live);
        # otherwise output is captured and replayed on completion
        r = subprocess.run([sys.executable, "-m", mod, "--device",
                            args.device],
                           capture_output=not args.progress,
                           text=True, env=env)
        dt = time.time() - t0
        sys.stdout.write(r.stdout or "")
        if r.returncode != 0:
            failed.append((mod, r.returncode))
            sys.stdout.write(f"[FAILED rc={r.returncode}]\n")
            sys.stdout.write((r.stderr or "")[-2000:] + "\n")
        print(f"[{mod}: {dt:.1f}s]", flush=True)
    # per-module failure summary: every module always runs (a broken
    # figure never shadows its siblings)
    print(f"\n{len(benches) - len(failed)}/{len(benches)} benchmarks ok")
    if failed:
        print("failed benchmarks:", file=sys.stderr)
        for mod, rc in failed:
            print(f"  {mod} (rc={rc})", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
