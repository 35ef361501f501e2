"""The multi-seed protocol of the paper's Table 3 (port of
``fairmultimodal_tpu/eval/aggregate.py``; numpy only).

``--runs N`` repeats a pipeline over seeds (seed, seed+1, ...); each run's
result dict gives one row of per-task AUROC / AUPRC / EDDI % / EO %
(:func:`extract_table3_row`), :func:`aggregate_runs` takes their mean and
population std, :func:`format_table3` prints the Table-3-shaped block and
:func:`write_runs_csv` writes every value (``run,seed,task,metric,value``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["extract_table3_row", "aggregate_runs", "format_table3",
           "write_runs_csv"]

_TASK_DISPLAY = {
    "mortality": "Mortality",
    "short_term_mortality": "Mortality",
    "los": "LOS >= 7 d",
    "los_binary": "LOS >= 7 d",
    "mechanical_ventilation": "Ventilation",
    "ventilation": "Ventilation",
    "readmission": "Readmission",
}


def extract_table3_row(out: Dict) -> Dict[str, Dict[str, float]]:
    """One run's Table-3 quantities per task from a pipeline result dict."""
    row: Dict[str, Dict[str, float]] = {}
    metrics = out.get("metrics") or {}
    eddi = out.get("eddi") or {}
    fairness = out.get("fairness") or {}
    for task, m in metrics.items():
        if not isinstance(m, dict) or "aucroc" not in m:
            continue
        entry = {"auroc": float(m["aucroc"]), "auprc": float(m["auprc"])}
        task_eddi = eddi.get(task)
        if isinstance(task_eddi, dict) and "combined_eddi" in task_eddi:
            entry["eddi_pct"] = 100.0 * float(task_eddi["combined_eddi"])
        task_fair = fairness.get(task)
        if isinstance(task_fair, dict) and "overall_eo" in task_fair:
            entry["eo_pct"] = 100.0 * float(task_fair["overall_eo"])
        row[task] = entry
    return row


def aggregate_runs(rows: Sequence[Dict[str, Dict[str, float]]]
                   ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """[{task: {metric: value}}] per run -> {task: {metric: {mean, std, n}}}.

    std is the population std (ddof=0) over the runs that produced the
    metric; NaN values are dropped per metric (a failed AUROC in one run
    should not poison the whole table)."""
    tasks: List[str] = []
    for r in rows:
        for t in r:
            if t not in tasks:
                tasks.append(t)
    agg: Dict[str, Dict[str, Dict[str, float]]] = {}
    for t in tasks:
        agg[t] = {}
        keys: List[str] = []
        for r in rows:
            for k in r.get(t, {}):
                if k not in keys:
                    keys.append(k)
        for k in keys:
            vals = np.asarray([r[t][k] for r in rows
                               if t in r and k in r[t]], dtype=np.float64)
            vals = vals[np.isfinite(vals)]
            if len(vals) == 0:
                agg[t][k] = {"mean": float("nan"), "std": float("nan"), "n": 0}
            else:
                agg[t][k] = {"mean": float(vals.mean()),
                             "std": float(vals.std()),
                             "n": int(len(vals))}
    return agg


def format_table3(agg: Dict[str, Dict[str, Dict[str, float]]],
                  n_runs: int) -> str:
    """Markdown table in the paper's Table-3 shape (README.md:218-222)."""
    lines = [f"{n_runs}-run averages (mean ± std)",
             "",
             "| Task        | AUROC ↑ | AUPRC ↑ | EDDI % ↓ | EO % ↓ |",
             "| ----------- | ------- | ------- | -------- | ------ |"]

    def cell(task, key, digits):
        stat = agg.get(task, {}).get(key)
        if not stat or stat["n"] == 0 or not np.isfinite(stat["mean"]):
            return "-"
        return f"{stat['mean']:.{digits}f} ± {stat['std']:.{digits}f}"

    for task in agg:
        name = _TASK_DISPLAY.get(task, task)
        lines.append(
            f"| {name:<11} | {cell(task, 'auroc', 2)} | {cell(task, 'auprc', 2)} "
            f"| {cell(task, 'eddi_pct', 2)} | {cell(task, 'eo_pct', 2)} |")
    return "\n".join(lines)


def write_runs_csv(path: str, rows: Sequence[Dict[str, Dict[str, float]]],
                   seeds: Sequence[int],
                   agg: Optional[Dict] = None) -> None:
    """Per-run rows + mean/std rows, long format: run,seed,task,metric,value."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run", "seed", "task", "metric", "value"])
        for i, (row, seed) in enumerate(zip(rows, seeds)):
            for task, m in row.items():
                for k, v in m.items():
                    w.writerow([i, seed, task, k, repr(float(v))])
        if agg:
            for task, m in agg.items():
                for k, stat in m.items():
                    w.writerow(["mean", "", task, k, repr(stat["mean"])])
                    w.writerow(["std", "", task, k, repr(stat["std"])])
