"""Paper Table 1 / Fig. 10: DRAM current vs. channel frequency (port of
``benchmarks/paper_table1.py``).  A closed-form energy model: host
arithmetic only, nothing runs on a device (``--device`` is accepted for
``run.py``'s common command line)."""
from repro_torch.benchmarks._util import main_args
from repro_torch.core.smla import energy as E

PAPER = {
    "Power-Down Current (mA)": [0.24, 0.24, 0.24, 0.24],
    "Precharge-Standby Current (mA)": [4.24, 5.39, 6.54, 8.84],
    "Active-Standby Current (mA)": [7.33, 8.50, 9.67, 12.0],
    "Active-Precharge wo Standby (nJ)": [1.36, 1.37, 1.38, 1.41],
    "Read wo Standby (nJ)": [1.93] * 4,
    "Write wo Standby (nJ)": [1.33] * 4,
}


def run() -> list[str]:
    ours = E.table1()
    rows = ["metric,200MHz,400MHz,800MHz,1600MHz,paper_match"]
    for k, vals in ours.items():
        paper_vals = PAPER.get(k)
        if paper_vals is None:
            # rows beyond the published table (e.g. the self-refresh
            # retention current): modelled, not paper-checkable
            rows.append(f"{k},{','.join(str(v) for v in vals)},"
                        f"model-extension")
            continue
        match = all(abs(a - b) < 5e-3 for a, b in zip(vals, paper_vals))
        rows.append(f"{k},{','.join(str(v) for v in vals)},{match}")
        assert match, (k, vals, paper_vals)
    # every published row must still be reproduced
    assert set(PAPER) <= set(ours), sorted(set(PAPER) - set(ours))
    return rows


if __name__ == "__main__":
    main_args(__doc__)
    print("\n".join(run()))
