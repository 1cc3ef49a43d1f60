"""Paper Table 2: evaluated 3D-stacked DRAM configurations (port of
``benchmarks/paper_table2.py``).  Host arithmetic only, nothing runs on
a device (``--device`` is accepted for ``run.py``'s common command
line)."""
from repro_torch.benchmarks._util import main_args
from repro_torch.core.smla.analytic import table2

PAPER = {  # name -> (ranks, clock MHz, BW GB/s, avg transfer ns)
    "baseline": (4, 200, 3.2, 20.0),
    "dedicated_mlr": (1, 800, 12.8, 5.0),
    "dedicated_slr": (4, 800, 12.8, 20.0),
    "cascaded_mlr": (1, 800, 12.8, 5.0),
    "cascaded_slr": (4, 800, 12.8, 18.125),   # footnote: 16.25..20
}


def run() -> list[str]:
    t2 = table2(layers=4)
    rows = ["config,ranks,clock_mhz,bandwidth_gbps,avg_transfer_ns,paper_match"]
    for name, (r, clk, bw, ns) in PAPER.items():
        v = t2[name]
        ok = (v["n_ranks"] == r and abs(v["clock_mhz"] - clk) < 1e-6
              and abs(v["bandwidth_gbps"] - bw) < 1e-6
              and abs(v["avg_transfer_ns"] - ns) < 1e-3)
        rows.append(f"{name},{v['n_ranks']},{v['clock_mhz']:.0f},"
                    f"{v['bandwidth_gbps']},{v['avg_transfer_ns']:.3f},{ok}")
        assert ok, (name, v)
    return rows


if __name__ == "__main__":
    main_args(__doc__)
    print("\n".join(run()))
