"""Aggregate roofline cell JSONs into markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.report results/

The counterpart of `repro.launch.report`: the same rows print the same
strings (the reference's ``single_pod_only`` filter on its pod's mesh
name and its unread ``--markdown`` flag are left out). A row is a
`launch.roofline.Roofline`'s ``to_dict`` plus ``status`` ("ok" or the
failure) and, optionally, ``memory_analysis`` (``temp_size_in_bytes``),
one ``cell_*.json`` file per cell.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(results_dir: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(results_dir, "cell_*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b):
    if b is None:
        return "—"
    return f"{b/2**30:.1f}GiB"


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) "
           "| dominant | useful | roofline | temp/chip | status |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','?')} "
                         f"| — | — | — | — | — | — | — | {r['status'][:40]} |")
            continue
        ma = r.get("memory_analysis") or {}
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']*1e3:.1f} | {r['t_memory_s']*1e3:.1f} "
            f"| {r['t_collective_s']*1e3:.1f} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.4f} "
            f"| {fmt_bytes(ma.get('temp_size_in_bytes'))} | ok |")
    return "\n".join(lines)


def summarize(rows: List[Dict]) -> str:
    ok = [r for r in rows if r.get("status") == "ok"]
    bad = [r for r in rows if r.get("status") != "ok"]
    out = [f"{len(ok)}/{len(rows)} cells ok; {len(bad)} failed"]
    if ok:
        worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:3]
        out.append("worst roofline fraction: " + ", ".join(
            f"{r['arch']}x{r['shape']}x{r['mesh']}"
            f"({r['roofline_fraction']:.4f})" for r in worst))
        coll = sorted(ok, key=lambda r: -r["t_collective_s"] /
                      max(r["t_compute_s"], 1e-12))[:3]
        out.append("most collective-bound (t_coll/t_comp): " + ", ".join(
            f"{r['arch']}x{r['shape']}x{r['mesh']}"
            f"({r['t_collective_s']/max(r['t_compute_s'],1e-12):.1f}x)"
            for r in coll))
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dir", nargs="?", default="results")
    args = ap.parse_args()
    rows = load(args.results_dir)
    print(summarize(rows))
    print()
    print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
