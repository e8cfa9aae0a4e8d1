"""Checkpoints (interchangeable with glass_tpu), the step meter, profiling
and the captured training steps and inference programs (``graphs``)."""
