"""Evaluation: numpy metrics, the reference-format reports and (``eval.plots``)
the plots."""

from fairmultimodal_torch.eval.report import eddi_report, evaluate_multitask, task_metrics

__all__ = ["task_metrics", "evaluate_multitask", "eddi_report"]
