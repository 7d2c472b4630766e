"""Cases audited over the whole window; the window ends with a whole unit
(a wave or a case), so no case counts in part."""

from benchmark.core.readers import units_per_s as read  # noqa: F401
