"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures JAX.) Without a
CUDA device each test skips itself.
"""
import numpy as np
import pytest
import torch

from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run only on the card)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype,width', [
    ('float32', 128), ('bfloat16', 128),
    # narrower than the 32 padded feature rows of the skip input
    ('float32', 16)])
def test_kernels_match_plain_on_card(cuda_device, compute_dtype, width):
    """Forward and backward kernels against their plain versions on the
    same card inputs: emission atol 2e-6 / rtol 1e-4 (f32), gradients
    atol 5e-5 after normalising by the max, d_t rtol 2e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    nt, n, depth, deg = 3, 4 * fused.TILE_N, 4, 3
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width,
                         posenc_deg=deg, compute_dtype=compute_dtype)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
    weights, biases = [w.detach() for w in fused.pack_params(params)[0]], \
        [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        cuda_device).contiguous()
    t_eff = put(rng.uniform(0, 50, (nt, 1)))
    coords = put(rng.uniform(-8, 8, (3, n)))
    omega = put(rng.uniform(0.01, 0.1, (1, n)))
    tg = put(rng.uniform(-30, 30, (1, n)))
    smask = put(rng.random((1, n)) > 0.2)
    cfg = (depth, width, True)
    args = (t_eff, coords, omega, tg, smask, weights, biases, cfg, 8.0, deg,
            compute_dtype)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    em_p, f_p = fused.render_fwd_plain(*args, stash=True)
    torch.cuda.synchronize()
    tol = dict(atol=2e-6, rtol=1e-4) if compute_dtype == 'float32' \
        else dict(atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(), **tol)
    g = put(rng.standard_normal((nt, n)))
    # bf16: a cotangent that lands on a rounding boundary may round to the
    # neighbouring bf16 value in one version and not the other, so the
    # gradients are held to a normalised 1e-2 instead
    gtol = 5e-5 if compute_dtype == 'float32' else 1e-2
    for want_dt in (False, True):
        gk = fused.render_bwd(g, em_p, f_p, omega, weights, biases, cfg, deg,
                              compute_dtype, want_dt)
        gp = fused.render_bwd_plain(g, em_p, f_p, omega, weights, biases,
                                    cfg, deg, compute_dtype, want_dt)
        torch.cuda.synchronize()
        for a, b in zip(gp[0] + gp[1], gk[0] + gk[1]):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            scale = np.abs(a).max() + 1e-8
            np.testing.assert_allclose(b / scale, a / scale, atol=gtol)
        if want_dt and compute_dtype == 'float32':
            np.testing.assert_allclose(gk[2].cpu().numpy(),
                                       gp[2].cpu().numpy(), rtol=2e-3,
                                       atol=1e-6)
