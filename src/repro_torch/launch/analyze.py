"""Static kernel audit CLI: certify the port's mode x tier matrix.

Counterpart of ``repro/launch/analyze.py``.  Runs the certifier's passes
(``repro_torch.analysis``: interval overflow and exactness over the
fake-traced aten graph of each CUDA route with the kernels' carriers,
gather bounds, Hopper's block budgets) over every entry of
``analysis.audit.matrix_entries()`` and prints one verdict row each.
Nothing executes: every verdict comes from abstract interpretation, so
this runs on a machine with no card.

Exit status is non-zero if a deployed entry is unproven or a frontier
entry's verdict moved (a frontier entry is one where a bound binds:
seqmul past the dispatch contract, the packed word at n = 16, lowrank
attention at head width 256 and rank 24; the report shows each refusal
with its finding).

Usage:
  python -m repro_torch.launch.analyze                  # table + exit status
  python -m repro_torch.launch.analyze --report audit.json
  python -m repro_torch.launch.analyze --markdown       # the shared-memory table
"""

from __future__ import annotations

import argparse
import json
import sys


def _peak_smem(entry: dict) -> int:
    return max((s["smem"] + s["static_smem"] for s in entry["smem"]), default=0)


def _verdict(entry: dict) -> str:
    if entry["deployed"]:
        return "certified" if entry["certified"] else "UNPROVEN"
    word = "certified" if entry["certified"] else "refused"
    return f"{word} (frontier{'' if entry['as_expected'] else ', MOVED'})"


def _print_table(rep: dict) -> None:
    rows = [("entry", "family", "n", "t", "smem bytes", "verdict")]
    for e in rep["entries"]:
        rows.append((e["name"], e["family"], str(e["n"]), str(e["t"]),
                     str(_peak_smem(e)) if e["smem"] else "-", _verdict(e)))
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    for i, row in enumerate(rows):
        print("  ".join(cell.ljust(w) for cell, w in zip(row, widths)))
        if i == 0:
            print("  ".join("-" * w for w in widths))


def _print_findings(rep: dict) -> None:
    for e in rep["entries"]:
        if e["certified"]:
            continue
        print(f"\n{e['name']}: NOT certified{'' if e['deployed'] else ' (frontier entry)'}")
        for f in e["findings"]:
            print(f"  [{'gating' if f['gating'] else 'note'}] {f['kind']}: {f['message']}")
        for key in ("derived_frontier_n", "dispatch_contract_n"):
            if key in e["facts"]:
                print(f"  {key.replace('_', ' ')}: {e['facts'][key]}")


def _markdown_table(rep: dict) -> str:
    """Every entry's largest block against the 232,448 bytes a Hopper block may use."""
    limit = rep["smem_per_block_bytes"]
    lines = [
        f"| Entry | family | n | t | largest block (bytes of shared memory) | "
        f"limit {limit} | verdict |",
        "|---|---|---|---|---|---|---|",
    ]
    for e in rep["entries"]:
        peak = _peak_smem(e)
        within = all(s["within"] for s in e["smem"]) and not any(
            f["kind"] == "smem-budget" for f in e["findings"])
        lines.append(
            f"| `{e['name']}` | {e['family']} | {e['n']} | {e['t']} | "
            f"{peak if e['smem'] else '-'} | {'within' if within else '**over**'} | "
            f"{_verdict(e)} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="statically certify every (mode, n, t) kernel configuration of the port",
    )
    parser.add_argument("--report", metavar="PATH",
                        help="write the machine-readable JSON report here")
    parser.add_argument("--markdown", action="store_true",
                        help="print the shared-memory table (markdown) instead of the rows")
    args = parser.parse_args(argv)

    from repro_torch.analysis import audit

    rep = audit.report()
    ok = rep["all_deployed_certified"] and rep["frontier_holds"]
    if args.markdown:
        print(_markdown_table(rep))
    else:
        _print_table(rep)
        _print_findings(rep)
        entries = rep["entries"]
        deployed = [e for e in entries if e["deployed"]]
        print(f"\n{len(entries)} configurations audited: {len(deployed)} deployed, "
              f"{sum(e['certified'] for e in deployed)} of them certified; "
              f"{len(entries) - len(deployed)} frontier entries, "
              f"{sum(e['as_expected'] for e in entries if not e['deployed'])} as expected")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(rep, fh, indent=2)
        print(f"report written to {args.report}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
