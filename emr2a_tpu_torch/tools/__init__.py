"""Run-time tools of the port: the synthetic CT cohort that ``chip_smoke.py``
and the profiler write, and the step2 profiler
(``python -m emr2a_tpu_torch.tools.profile_tower``)."""
