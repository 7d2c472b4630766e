from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder, BioMedCLIPLEncoder
from emr2a_tpu_torch.encoders.fake import FakeEncoder
from emr2a_tpu_torch.encoders.factory import create_encoder

__all__ = [
    "BaseEncoder",
    "BioMedCLIPEncoder",
    "BioMedCLIPLEncoder",
    "FakeEncoder",
    "create_encoder",
]
