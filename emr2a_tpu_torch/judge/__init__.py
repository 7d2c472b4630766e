from emr2a_tpu_torch.judge.audit import VLMAuditModule
from emr2a_tpu_torch.judge.backends import FakeVLMBackend, VLMBackend
from emr2a_tpu_torch.judge.parsers import (
    extract_json_payload,
    parse_audit_output,
)
from emr2a_tpu_torch.judge.review import VLMReviewModule

__all__ = [
    "VLMAuditModule",
    "VLMReviewModule",
    "VLMBackend",
    "FakeVLMBackend",
    "parse_audit_output",
    "extract_json_payload",
]
