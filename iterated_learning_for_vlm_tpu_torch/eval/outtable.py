"""Result aggregation table.

A copy of ``iterated_learning_for_vlm_tpu/eval/outtable.py``.

Parity target: reference ``outtable.py`` — scan ``results/**/*.json`` eval
dumps and print one table per task (BeautifulTable there; plain text here).
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List


def collect_results(root: str) -> Dict[str, List[dict]]:
    by_task = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(root, "**", "*.json"), recursive=True)):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if isinstance(rec, dict) and "metrics" in rec:
            by_task[rec.get("task", "unknown")].append(rec)
    return dict(by_task)


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    cols = [header] + rows
    widths = [max(len(str(r[i])) for r in cols) for i in range(len(header))]
    line = "+".join("-" * (w + 2) for w in widths)

    def fmt_row(r):
        return "|".join(f" {str(v).ljust(w)} " for v, w in zip(r, widths))

    out = [line, fmt_row(header), line]
    out += [fmt_row(r) for r in rows]
    out.append(line)
    return "\n".join(out)


def render(root: str) -> str:
    blocks = []
    for task, recs in collect_results(root).items():
        metric_keys = sorted({k for r in recs for k in _flat_metrics(r["metrics"])})
        header = ["dataset", "pretrained"] + metric_keys
        rows = []
        for r in recs:
            flat = _flat_metrics(r["metrics"])
            rows.append(
                [r.get("dataset", ""), os.path.basename(str(r.get("pretrained", "")))]
                + [f"{flat.get(k, float('nan')):.4f}" if k in flat else "-" for k in metric_keys]
            )
        blocks.append(f"== task: {task} ==\n" + _fmt_table(rows, header))
    return "\n\n".join(blocks)


def _flat_metrics(metrics: dict, prefix: str = "") -> Dict[str, float]:
    out = {}
    for k, v in metrics.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_metrics(v, key + "/"))
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


if __name__ == "__main__":
    import sys

    print(render(sys.argv[1] if len(sys.argv) > 1 else "results"))
