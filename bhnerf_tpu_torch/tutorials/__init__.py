"""The reference's five tutorials on the PyTorch package.

PyTorch-package counterparts of tutorials/tutorial{1..5}_*.py: each runs
as ``python -m bhnerf_tpu_torch.tutorials.<name> [--small] [--out DIR]``
and has ``main(out_dir, small=False, device='cuda')``, which computes on
`device`, returns the numbers it prints, and draws its figures where
matplotlib imports (the computing is the same without it).
"""
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        print('# matplotlib is not installed: no figures', flush=True)
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def array_path(name):
    """The station table `name` of the repository's eht_arrays/."""
    return os.path.join(REPO, 'eht_arrays', name)


def fused_launches():
    """(forward, backward) launches of the fused render kernels so far."""
    from bhnerf_tpu_torch.ops import fused
    return fused.render_fwd.launches, fused.render_bwd.launches
