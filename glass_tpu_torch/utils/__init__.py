"""Checkpoints (interchangeable with glass_tpu), the step meter, profiling
and the captured inference programs (``graphs``)."""
