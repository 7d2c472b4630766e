"""The reference's import location for the audit module."""

from emr2a_tpu_torch.judge.audit import (  # noqa: F401
    VLMAuditModule,
    create_montage,
    select_even_slices,
)
