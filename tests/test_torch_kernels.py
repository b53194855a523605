"""The port's hand-written kernels on the card, against their plain PyTorch
versions. These need a CUDA card and skip without one; this file imports no
JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX.) ``chip_smoke.py``
holds the same kernels at full width."""

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch.data import DatasetConfig
from acoustic_locating_vq_vae_torch.dsp import znorm
from acoustic_locating_vq_vae_torch.eval import full_fp32, make_serving_fn
from acoustic_locating_vq_vae_torch.ops import vq
from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda
from acoustic_locating_vq_vae_torch.train import JointLocationTask, LocationTask

SHAPES = [(512, 128, 1024), (100, 4, 16), (1000, 64, 1024), (513, 128, 100), (12864, 64, 1024)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_kernel_matches_plain_on_card(card, n, d, k):
    """Equal indices, except rows whose two codes tie in float64 to 1e-6 of
    the squared norms (cuBLAS sums in another order), at most 0.1% of rows."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
    cb = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(card)
    e2 = (cb * cb).sum(1)
    with full_fp32():
        got = nearest_indices_cuda(x, cb, e2).long().cpu()
        want = vq.nearest_indices(x, cb, e2).cpu()
    rows = torch.nonzero(got != want).flatten()
    x64, cb64 = x.cpu().double()[rows], cb.cpu().double()
    gap = (((x64 - cb64[got[rows]]) ** 2).sum(1) - ((x64 - cb64[want[rows]]) ** 2).sum(1)).abs()
    scale = (x64**2).sum(1) + (cb64**2).sum(1).max()
    assert bool((gap <= 1e-6 * scale).all())
    assert rows.numel() <= 1e-3 * n


@pytest.mark.cuda
def test_kernel_ties_take_the_first_index(card):
    got = nearest_indices_cuda(torch.ones(70, 4, device=card), torch.ones(90, 4, device=card), torch.full((90,), 4.0, device=card))
    assert torch.equal(got.cpu(), torch.zeros(70, dtype=torch.int32))


@pytest.mark.cuda
def test_kernel_launch_is_counted_and_assign_uses_it(card):
    x = torch.randn(300, 8, device=card)
    cb = torch.randn(20, 8, device=card)
    before = nearest_indices_cuda.launches
    idx, q = vq.assign(x, cb)
    assert nearest_indices_cuda.launches == before + 1
    assert torch.equal(q, cb[idx])
    with pytest.raises(ValueError, match="float32"):
        nearest_indices_cuda(x.double(), cb, (cb * cb).sum(1))
    with pytest.raises(ValueError, match="contiguous"):
        nearest_indices_cuda(x.T.contiguous().T, cb, (cb * cb).sum(1))


def _latent_codebook_(rir, spec, g):
    """Replace the codebook by pre-VQ latent rows: an untrained U(+-1/K)
    codebook makes the argmin a near-tie lottery."""
    with torch.no_grad():
        z = rir.pre_vq_latent(znorm(spec, dim=1).transpose(1, 2))
        rows = (z if rir.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, rir.embedding_dim)
        pick = torch.randperm(rows.shape[0], generator=g)[: rir.num_embeddings]
        rir._vq._embedding.weight.copy_(rows[pick])


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "frozen"])
def test_serving_on_card_matches_cpu(card, frozen):
    """The serving path at width 1/16 on the card agrees with the CPU."""
    g = torch.Generator().manual_seed(0)
    cfg = DatasetConfig()
    spec, other = torch.empty(2, 4, 201, 500).exponential_(generator=g)
    if frozen:
        task = LocationTask(width_scale=1 / 16)
        rir = task.build_rir_model(g)
        _latent_codebook_(rir, other, g)
        params, comp = task.build_model(g).state_dict(), rir.state_dict()
    else:
        task = JointLocationTask(width_scale=1 / 16, predict_radius=True)
        model = task.build_model(g)
        _latent_codebook_(model.rir_model, other, g)
        params, comp = model.state_dict(), None
    before = nearest_indices_cuda.launches
    got = make_serving_fn(task, params, cfg, comp, device=card)(spec)
    assert nearest_indices_cuda.launches == before + 1
    want = make_serving_fn(task, params, cfg, comp, device="cpu")(spec)
    for a, b in zip(got, want):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
