"""The port's native image-source library (``native/``) on the CPU.

* against the JAX package's ``native`` (the same algorithm, compiler and
  flags, built from the port's own copy of ``ism.cpp``): bitwise, for one
  source and a batch of two, ``rt60`` and ``beta``, ``order=-1`` and
  ``order=3``, the high-pass on and off;
* against the port's ``dsp.generate_rir``: in float32 within JAX's own
  tolerance (atol 5e-4 of the max, rtol 1e-2), in float64 within 1e-9 of the
  max;
* JAX's ``ValueError`` messages, word for word; a tensor that is not on the
  host refused; CPU tensors taken as arrays;
* the library lies under ``build/native/`` and was compiled from the port's
  ``native/ism.cpp``, whose code below its header comment is the JAX
  package's;
* ``dsp.generate_rir`` without the cull (every lattice image, the farthest
  chunks wholly beyond the window) against the library in float64 and
  against JAX's in float32.

A failed build fails these tests; the only skip is a missing g++. The
``cuda`` test needs a card and skips without one; it runs where JAX is
absent, with the card's other tests (README.md)."""

import hashlib
import itertools
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch import dsp, native
from acoustic_locating_vq_vae_torch.native import ism

try:
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import dsp as jdsp
    from acoustic_locating_vq_vae_tpu import native as jnative
except ImportError:  # the card's machine: only the cuda test runs there
    jnp = jdsp = jnative = None

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH: the native ISM library is built "
                                                                    "with g++ at first use")

REPO = Path(__file__).resolve().parents[1]
ROOM = (4.0, 5.0, 3.0)
RECEIVER = np.array([2.5, 1.5, 1.5])
SOURCE = np.array([3.2, 2.1, 1.0])
SOURCES = np.stack([SOURCE, SOURCE + [0.0, 0.4, 0.3]])
FS = 16000.0
NSAMPLE = 512
BETA = 0.7
WALLS = (0.7, 0.65, 0.8, 0.75, 0.6, 0.9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("sources,absorption,order,hp", list(itertools.product(
    [SOURCE, SOURCES], [{"rt60": 0.4}, {"beta": BETA}, {"beta": WALLS}], [-1, 3], [True, False])),
    ids=lambda v: {id(SOURCE): "one", id(SOURCES): "two"}.get(id(v), str(v)))
def test_bitwise_the_jax_library(sources, absorption, order, hp):
    got = native.generate_rir_native(sources, RECEIVER, ROOM, NSAMPLE, FS, order=order, hp=hp, **absorption)
    want = jnative.generate_rir_native(sources, RECEIVER, ROOM, NSAMPLE, FS, order=order, hp=hp, **absorption)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == ((NSAMPLE,) if sources.ndim == 1 else (2, NSAMPLE))
    assert np.array_equal(got.numpy(), want)
    assert float(got.abs().max()) > 0


def test_cpu_tensors_are_taken_as_arrays():
    f64 = dict(dtype=torch.float64)
    got = native.generate_rir_native(torch.from_numpy(SOURCES), torch.from_numpy(RECEIVER), torch.tensor(ROOM, **f64),
                                     NSAMPLE, FS, beta=torch.tensor(WALLS, **f64))
    assert torch.equal(got, native.generate_rir_native(SOURCES, RECEIVER, ROOM, NSAMPLE, FS, beta=WALLS))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, None), (torch.float64, 1e-9)], ids=["float32", "float64"])
def test_matches_the_ports_generate_rir(dtype, tol):
    """float32: JAX's tests/test_native_ism.py tolerance; float64: the
    tolerance of tests/test_torch_dsp.py's oracle test."""
    ours = dsp.generate_rir(torch.tensor(SOURCE, dtype=dtype), torch.tensor(RECEIVER, dtype=dtype), room=ROOM,
                            nsample=NSAMPLE, fs=FS, beta=BETA, hp=True, chunk=256).numpy()
    cpp = native.generate_rir_native(SOURCE, RECEIVER, ROOM, NSAMPLE, FS, beta=BETA, hp=True).numpy()
    scale = np.abs(cpp).max()
    if tol is None:
        np.testing.assert_allclose(ours, cpp, atol=5e-4 * scale, rtol=1e-2)
    else:
        assert np.abs(ours - cpp).max() <= tol * scale


@pytest.mark.parametrize("nsample,chunk", [(512, 64), (512, 256), (1024, 128)])
def test_generate_rir_without_the_cull(nsample, chunk):
    """``cull=False`` walks every lattice image, so the farthest chunks lie
    wholly beyond the window (all their gains 0); the port's accumulation
    clamps their block range into its buffer as JAX's dynamic_update_slice
    does (it raised before). float64 within 1e-9 of the library's max, and
    the same RIR as the cull's; float32 within 1e-5 of JAX's max (the
    tolerance of tests/test_torch_dsp.py's JAX comparison)."""
    kw = dict(room=ROOM, nsample=nsample, fs=FS, rt60=0.4, chunk=chunk)
    cpp = native.generate_rir_native(SOURCE, RECEIVER, ROOM, nsample, FS, rt60=0.4).numpy()
    got64 = dsp.generate_rir(torch.from_numpy(SOURCE), torch.from_numpy(RECEIVER), cull=False, **kw).numpy()
    culled = dsp.generate_rir(torch.from_numpy(SOURCE), torch.from_numpy(RECEIVER), cull=True, **kw).numpy()
    assert np.abs(got64 - cpp).max() <= 1e-9 * np.abs(cpp).max()
    assert np.abs(got64 - culled).max() <= 1e-12 * np.abs(cpp).max()
    if nsample == 512:
        want = np.asarray(jdsp.generate_rir(jnp.asarray(SOURCE, jnp.float32), jnp.asarray(RECEIVER, jnp.float32),
                                            cull=False, **kw))
        got = dsp.generate_rir(torch.tensor(SOURCE, dtype=torch.float32), torch.tensor(RECEIVER, dtype=torch.float32),
                               cull=False, **kw).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("args,kwargs", [
    ((SOURCE,), {}),  # neither rt60 nor beta
    ((SOURCE,), {"rt60": 0.4, "beta": 0.5}),  # both
    ((np.zeros((2, 4)),), {"beta": 0.5}),  # bad shape
    ((SOURCE,), {"beta": (0.5, 0.5, 0.5)}),  # beta neither scalar nor of six walls
], ids=["neither", "both", "bad-shape", "beta-length"])
def test_errors_are_jaxs(args, kwargs):
    with pytest.raises(ValueError) as want:
        jnative.generate_rir_native(*args, RECEIVER, ROOM, NSAMPLE, FS, **kwargs)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        native.generate_rir_native(*args, RECEIVER, ROOM, NSAMPLE, FS, **kwargs)


def test_a_tensor_off_the_host_is_refused():
    """No hidden copy to the host: a tensor on another device raises (on the
    CPU the meta device stands in for the card)."""
    with pytest.raises(ValueError, match="runs on the host"):
        native.generate_rir_native(torch.empty(3, device="meta"), RECEIVER, ROOM, NSAMPLE, FS, beta=BETA)


@pytest.mark.cuda
def test_a_cuda_tensor_is_refused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.raises(ValueError, match="runs on the host"):
        native.generate_rir_native(torch.tensor(SOURCE, device="cuda"), RECEIVER, ROOM, NSAMPLE, FS, beta=BETA)


def test_available_and_threads():
    assert native.is_available()
    assert native.num_threads() >= 1


def test_built_under_build_native_from_the_ports_source():
    path = Path(native.build())
    assert path.parent == REPO / "build" / "native"
    assert path.is_file()
    assert ism.SOURCE == REPO / "src" / "acoustic_locating_vq_vae_torch" / "native" / "ism.cpp"
    flags = ism.FLAGS if path == ism.library_path(ism.FLAGS) else ism.FALLBACK_FLAGS
    digest = hashlib.sha256(ism.SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    assert path.name == f"ism-{digest}.so"
    assert not (REPO / "src" / "acoustic_locating_vq_vae_torch" / "native" / "_build").exists()

    def code(p: Path) -> str:  # the source below its header comment
        return p.read_text()[p.read_text().index("#include"):]

    assert code(ism.SOURCE) == code(REPO / "src" / "acoustic_locating_vq_vae_tpu" / "native" / "ism.cpp")
