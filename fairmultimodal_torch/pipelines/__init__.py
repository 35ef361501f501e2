"""Experiment pipelines (port of ``fairmultimodal_tpu.pipelines``).

========  ====================================  ==============================
script    pipeline                              module
========  ====================================  ==============================
01        run_behrt_experiment                  pipelines/behrt.py
02        run_text_only_experiment              pipelines/text_only.py
03        run_dfc_experiment                    pipelines/dfc.py
04        run_adv_debias_experiment             pipelines/adv_debias.py
05 / 10   run_fame_experiment                   pipelines/fame.py
06        run_fairehr_clp_experiment            pipelines/fairehr_clp.py
07        run_average_fusion_experiment         pipelines/average_fusion.py
08        run_eddi_fusion_experiment            pipelines/eddi_fusion.py
09        run_sigmoid_fusion_experiment         pipelines/sigmoid_fusion.py
legacy    run_legacy_behrt_experiment,          pipelines/legacy.py
          run_legacy_eddi_experiment
serving   run_fame_inference                    pipelines/inference.py
========  ====================================  ==============================

Not ported yet (ROADMAP queue 1): 00 data.
"""

from fairmultimodal_torch.pipelines.adv_debias import (AdvDebiasPipelineConfig,
                                                       run_adv_debias_experiment)
from fairmultimodal_torch.pipelines.average_fusion import (AverageFusionPipelineConfig,
                                                           run_average_fusion_experiment)
from fairmultimodal_torch.pipelines.behrt import BEHRTPipelineConfig, run_behrt_experiment
from fairmultimodal_torch.pipelines.dfc import DfCPipelineConfig, run_dfc_experiment
from fairmultimodal_torch.pipelines.eddi_fusion import (EDDIFusionPipelineConfig,
                                                        run_eddi_fusion_experiment)
from fairmultimodal_torch.pipelines.fairehr_clp import (FairEHRCLPPipelineConfig,
                                                        run_fairehr_clp_experiment)
from fairmultimodal_torch.pipelines.fame import FAMEPipelineConfig, run_fame_experiment
from fairmultimodal_torch.pipelines.legacy import (LegacyBEHRTPipelineConfig,
                                                   LegacyEDDIPipelineConfig,
                                                   run_legacy_behrt_experiment,
                                                   run_legacy_eddi_experiment)
from fairmultimodal_torch.pipelines.sigmoid_fusion import (SigmoidFusionPipelineConfig,
                                                           run_sigmoid_fusion_experiment)
from fairmultimodal_torch.pipelines.text_only import (TextOnlyPipelineConfig,
                                                      run_text_only_experiment)

__all__ = [
    "FAMEPipelineConfig", "run_fame_experiment",
    "BEHRTPipelineConfig", "run_behrt_experiment",
    "TextOnlyPipelineConfig", "run_text_only_experiment",
    "DfCPipelineConfig", "run_dfc_experiment",
    "AdvDebiasPipelineConfig", "run_adv_debias_experiment",
    "FairEHRCLPPipelineConfig", "run_fairehr_clp_experiment",
    "AverageFusionPipelineConfig", "run_average_fusion_experiment",
    "EDDIFusionPipelineConfig", "run_eddi_fusion_experiment",
    "SigmoidFusionPipelineConfig", "run_sigmoid_fusion_experiment",
    "LegacyBEHRTPipelineConfig", "run_legacy_behrt_experiment",
    "LegacyEDDIPipelineConfig", "run_legacy_eddi_experiment",
]
