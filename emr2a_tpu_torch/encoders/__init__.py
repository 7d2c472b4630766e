from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder, BioMedCLIPLEncoder
from emr2a_tpu_torch.encoders.clip_encoder import CLIPEncoder
from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder
from emr2a_tpu_torch.encoders.factory import create_encoder
from emr2a_tpu_torch.encoders.fake import FakeEncoder
from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder
from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder

# the reference's class names: its 2B and 8B thinking encoders were
# byte-identical, and are one configurable class here
Qwen3VL8BThinkingEncoder = Qwen3VL2BThinkingEncoder = Qwen3VLEncoder

__all__ = [
    "BaseEncoder",
    "BioMedCLIPEncoder",
    "BioMedCLIPLEncoder",
    "CLIPEncoder",
    "DINOEncoder",
    "FakeEncoder",
    "Qwen3VLEncoder",
    "ViTEncoder",
    "Qwen3VL8BThinkingEncoder",
    "Qwen3VL2BThinkingEncoder",
    "create_encoder",
]
