"""The port's command line (``python -m fairmultimodal_torch.cli``): the JAX
package's parser and the ``fame``, ``fpm`` and ``predict`` pipelines."""

from fairmultimodal_torch.cli.main import build_parser, main, run_pipeline

__all__ = ["build_parser", "main", "run_pipeline"]
