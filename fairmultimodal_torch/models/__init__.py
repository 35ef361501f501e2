"""Encoders, fusion heads and the baseline models (port of
``fairmultimodal_tpu.models``), exported under the JAX package's names."""

from fairmultimodal_torch.models.baselines import (BEHRTFull, BEHRTLabOnlyModel, EDDIFusionFull,
                                                   SigmoidFusionFull, StructTextModel,
                                                   TextOnlyClassifier)
from fairmultimodal_torch.models.behrt import BEHRTCombined, BEHRTDemo, BEHRTLab
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel
from fairmultimodal_torch.models.fairehr import FairEHRCLP, contrastive_loss
from fairmultimodal_torch.models.fusion import (AverageFusionModel, DfCModel, EDDIFusionModel,
                                                FAMEFusion, FAMEModel, SigmoidFusionModel)
from fairmultimodal_torch.models.legacy import (BEHRTSequence, EDDIDotFusion,
                                                EDDIEnhancementLayer)
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks

__all__ = [
    "BertConfig", "BertEncoderModel", "BEHRTDemo", "BEHRTLab", "BEHRTCombined",
    "FAMEFusion", "FAMEModel", "AverageFusionModel", "SigmoidFusionModel", "DfCModel",
    "EDDIFusionModel", "TextEncoder", "encode_note_chunks", "BEHRTFull", "StructTextModel",
    "TextOnlyClassifier", "SigmoidFusionFull", "EDDIFusionFull", "BEHRTLabOnlyModel",
    "FairEHRCLP", "contrastive_loss", "BEHRTSequence", "EDDIDotFusion", "EDDIEnhancementLayer",
]
