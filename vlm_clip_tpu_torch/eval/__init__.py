"""See the package docstring of vlm_clip_tpu_torch."""
