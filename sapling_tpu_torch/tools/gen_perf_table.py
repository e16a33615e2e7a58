"""Regenerate the port's measured-performance table in README.md from
docs/measured_torch.json (PyTorch port; the twin of
tools/gen_perf_table.py).

docs/measured_torch.json has the JAX tool's schema (scales, aligner,
length_sweep, footnote, measured_on) and holds only numbers measured on
the card, with the card's name and power limit in measured_on; the
reference C++ columns are carried over from docs/measured.json where the
scale is the same, else null (shown as "—"). Then:

    python -m sapling_tpu_torch.tools.gen_perf_table [readme=README.md]
        [data=docs/measured_torch.json]

rewrites the block between `<!-- perf-torch:begin -->` and
`<!-- perf-torch:end -->` in the README. The TPU table (`perf:` markers,
docs/measured.json) is not touched.
"""

from __future__ import annotations

import json
import os
import re
import sys

from ..config import parse_keyval_args

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fmt_qps(v):
    if v is None:
        return "—"
    return f"{v/1e6:.2f}M q/s" if v >= 1e6 else f"{v/1e3:.0f}k q/s"


def _binsearch_ratio(r) -> str:
    b = r.get("onchip_binsearch_qps")
    return "—" if b is None else f"{r['qps'] / b:,.1f}×"


def table(data: dict) -> str:
    """The markdown block for measured_torch.json's contents. The
    reference columns were not run on the card's machine, so no ratio is
    taken to them; the binary search's was, on the same card."""
    rows = [f"| {r['label']} | **{fmt_qps(r['qps'])}** ({r['config']}) "
            f"| {fmt_qps(r.get('ref_qps'))} "
            f"| {_binsearch_ratio(r)} |"
            for r in data["scales"]]
    lines = ["| Genome scale | The port on the card | Reference best (1 CPU "
             "thread, not run on the card's machine) | vs on-card binary "
             "search |",
             "|---|---|---|---|", *rows, "", data["footnote"]]
    al = data.get("aligner")
    if al is not None:
        def one(s):
            ref = s.get("ref_reads_per_s")
            ref = ("no reference run at this scale" if ref is None else
                   f"reference {ref:,} reads/s, not run on the card's "
                   "machine")
            return (f"{s['genome']}: **{s['reads_per_s']:,.1f} reads/s** "
                    f"({ref})")
        lines += ["", f"Aligner (FASTQ→SAM, {al['label']}, {al['config']}) "
                  f"— {'; '.join(one(s) for s in al['scales'])}. "
                  f"{al['note']}."]
    sweep = data.get("length_sweep")
    if sweep is not None:
        ents = sweep["entries"]
        lines += ["",
                  "| Query length | " + " | ".join(str(e["len"])
                                                   for e in ents) + " |",
                  "|---|" + "---|" * len(ents),
                  f"| {sweep['label']} | " + " | ".join(
                      f"**{fmt_qps(e['qps'])}**" for e in ents) + " |"]
        if any(e.get("ref_qps") is not None for e in ents):
            lines.append("| Reference best (1 thread) | " + " | ".join(
                fmt_qps(e.get("ref_qps")) for e in ents) + " |")
        lines += ["", sweep["note"]]
    lines.append(f"\n*Measured {data['measured_on']}; regenerate with "
                 "`python -m sapling_tpu_torch.tools.gen_perf_table` from "
                 "docs/measured_torch.json.*")
    return "\n".join(lines)


def main(argv):
    kv = parse_keyval_args(argv[1:])
    readme = kv.get("readme", os.path.join(_ROOT, "README.md"))
    with open(kv.get("data", os.path.join(_ROOT, "docs",
                                          "measured_torch.json"))) as f:
        block = table(json.load(f))
    with open(readme) as f:
        src = f.read()
    out, nsub = re.subn(
        r"(<!-- perf-torch:begin -->\n).*?(<!-- perf-torch:end -->)",
        lambda m: m.group(1) + block + "\n" + m.group(2), src, flags=re.S)
    if nsub != 1:
        raise SystemExit(f"{readme}: perf-torch markers not found")
    with open(readme, "w") as f:
        f.write(out)
    print(f"{readme}: the port's performance table regenerated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
