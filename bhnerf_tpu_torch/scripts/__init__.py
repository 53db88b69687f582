"""Command-line fits of bhnerf_tpu_torch, each runnable with `python -m`."""
