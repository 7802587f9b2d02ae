"""The acoustic models (counterpart of viterbi_spl_tpu/models/): PyTorch
modules for the CFP families, jdc and dcnet, TONet's provenance backbones
(provenance.py), the losses and note grids, the family adapters, and the
weights carried across from flax (convert.py); imm's NMF (imm.py)."""

from .targets import (
    dcnet_loss,
    gaussian_blur_targets,
    jdc_loss,
    softmax_smoothed_loss,
    tonet_labels,
    tonet_loss,
)
from .dcnet import DCNet
from .msnet import MSNet
from .ftanet import FTANet
from .jdc import JDC
from .tonet import TONet, cfp_to_tcfp
from .provenance import MCDNN, MLDRnet, TonetMSNet

__all__ = [
    "DCNet",
    "MSNet",
    "FTANet",
    "JDC",
    "gaussian_blur_targets",
    "dcnet_loss",
    "softmax_smoothed_loss",
    "jdc_loss",
    "tonet_labels",
    "tonet_loss",
    "TONet",
    "cfp_to_tcfp",
    "MCDNN",
    "TonetMSNet",
    "MLDRnet",
]
