"""PyTorch/CUDA port of FAME, beside the JAX package ``fairmultimodal_tpu``.

The JAX package is the reference; this package imports ``torch`` and never
``jax``, ``flax`` or ``fairmultimodal_tpu``.  Plain tensor code is PyTorch and
every Pallas TPU kernel on a ported path is a CUDA kernel written for the
H100 (``sm_90a``) in ``fairmultimodal_torch/ops/csrc``.

Ported so far: the serving path -- ``pipelines.inference.FAMEPredictor`` and
``run_fame_inference`` with the frozen note encoder (``models.text``); the
training path -- ``train.loop.FAMETrainer`` in the folded, unfolded and
flash-route layer configurations; and the FAME experiment --
``pipelines.fame.run_fame_experiment`` (DataFrames) and ``run_fame_bundle``
(a ``FeatureBundle``, no pandas): splits, device-resident loaders,
calibration, evaluation with the EO / EDDI reports, artifacts; the baseline
pipelines 01 behrt, 02 text-only, 03 DfC, 06 FairEHR-CLP, 07 average fusion,
08 EDDI fusion, 09 sigmoid fusion and the legacy pair (``pipelines.common``,
``train.simple.MultitaskTrainer``, ``models.baselines``); 04's adversarial
debiasing (``pipelines.adv_debias``, ``train.adversarial``); profiling, NaN
checks and plots (``utils``, ``eval.plots``); the command line (``cli``); and
data-parallel training over ``torch.distributed`` (``parallel``, ``--mesh N``).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

TASKS = ("mortality", "los", "mechanical_ventilation")
# Label column names in the reference CSVs (00_data.py:303,310,315).
LABEL_COLUMNS = ("short_term_mortality", "los_binary", "mechanical_ventilation")
# Fairness code spaces expected by the reference (10_FAME.py:353-355,887-889).
EXPECTED_AGE_CODES = (0, 1, 2, 3)
EXPECTED_ETHNICITY_CODES = (0, 1, 2, 3, 4)
EXPECTED_INSURANCE_CODES = (0, 1, 2, 3, 4, 5)
# Human-readable subgroup names in reference print order
# (02_BioClinicalBERT.py:255-278 fixed orders; 10_FAME.py:644-691 mappers).
AGE_BUCKET_LABELS = ("15-29", "30-49", "50-69", "70-89")
ETHNICITY_LABELS = ("Asian", "Black", "Hispanic", "Other", "White")
INSURANCE_LABELS = ("Government", "Medicaid", "Medicare", "Other",
                    "Private", "Self Pay")
