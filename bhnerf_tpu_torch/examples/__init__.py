"""Worked examples of bhnerf_tpu_torch, each runnable with `python -m`."""
