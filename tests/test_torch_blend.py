"""The port's windowed blend (gaussiansplatting_tpu_torch.ops.blend) against
the JAX package's windowed Pallas kernel (pallas_blend.windowed_blend_fwd,
interpret mode on the CPU) on the same windows, and the CUDA kernel against
its plain version where a GPU is present.

The JAX kernel runs with GS_BLEND_POWER=vpu, its direct evaluation of the
quadratic form, which is the form the port's kernel and plain version use.
Its default monomial-matmul form rounds differently (up to 2.6e-5 in S_b at
|S_b| ~ 2.6 on these scenes, <= 2e-6 in colour); the image-level render
tests hold the port against that default at 2e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu.ops import pallas_blend

from gaussiansplatting_tpu_torch.ops import blend as tblend

from chip_smoke import edge_windows
from torch_parity import cameras, configs, jax_windows, scene_params, t2n

torch.set_num_threads(1)

TS, TILES_X, TILES_Y = 16, 4, 3
CONSTS = (TS, -4.5, 0.99, 1.0 / 255.0, TILES_X)
JCONSTS = CONSTS + (0, 0)       # JAX adds the (packed, pack_pos) flags


@pytest.fixture(autouse=True)
def _direct_power_form(monkeypatch):
    monkeypatch.setenv("GS_BLEND_POWER", "vpu")


def _jax_blend(table, src, valid, tile, row0, block):
    out, gid = pallas_blend.windowed_blend_fwd(
        jnp.asarray(table), jnp.asarray(src), jnp.asarray(valid),
        jnp.asarray(tile), row0, block, JCONSTS,
    )
    return np.asarray(out), np.asarray(gid)


def _port_blend(table, src, valid, tile, row0, block, device="cpu"):
    with torch.no_grad():
        out, gid = tblend.windowed_blend_fwd(
            torch.from_numpy(table).to(device), torch.from_numpy(src).to(device),
            torch.from_numpy(valid).to(device), torch.from_numpy(tile).to(device),
            row0, block, CONSTS,
        )
    return t2n(out), t2n(gid)


def _random_windows(seed, block, row0=0):
    return edge_windows(block, seed, row0, nb=10, ts=TS, tiles_x=TILES_X,
                        tiles_y=TILES_Y)


@pytest.mark.parametrize("block,row0", [(16, 0), (32, 1)])
def test_plain_matches_jax_kernel_random_windows(block, row0):
    args = _random_windows(21 + block, block, row0=row0) + (row0, block)
    out_j, gid_j = _jax_blend(*args)
    out_t, gid_t = _port_blend(*args)
    assert out_t.shape == (10, 4, TS * TS) and gid_t.shape == (10, block)
    # the JAX package's own Pallas-vs-XLA bar (test_pallas_blend.py:42)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)
    np.testing.assert_array_equal(gid_t, gid_j)
    # dead block: zeros and -1; partial block: -1 past valid
    valid = args[2]
    assert (out_t[0] == 0).all() and (gid_t[0] == -1).all()
    for b in range(10):
        assert (gid_t[b, valid[b]:] == -1).all()
        assert (gid_t[b, :valid[b]] >= 0).all()
    assert (out_t[1:, 3] < 0).any()                 # something was blended


@pytest.mark.parametrize("seed", [31, 32])
def test_plain_matches_jax_kernel_scene_windows(seed):
    """The windows a real render hands the blend (64x48 px, B=16)."""
    jp, _ = scene_params(seed, n=48)
    jc, _ = cameras()
    jcfg, _ = configs()
    _, windows, _ = jax_windows(jp, jc, jcfg)
    table, src, valid, bt, _ = (np.array(x) for x in windows)
    tile = np.minimum(bt, TILES_X * TILES_Y - 1).astype(np.int32)
    args = (table, src, valid, tile, 0, jcfg.pair_block)
    assert (valid == 0).any() and (valid > 0).any()
    out_j, gid_j = _jax_blend(*args)
    out_t, gid_t = _port_blend(*args)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)
    np.testing.assert_array_equal(gid_t, gid_j)


def test_plain_chunking_is_invisible():
    """Chunks of blocks are independent: any chunk size gives the same
    bits."""
    table, src, valid, tile = (torch.from_numpy(x) for x in _random_windows(41, 16))
    ref = tblend.windowed_blend_fwd_plain(table, src, valid, tile, 0, 16, CONSTS)
    for chunk in (1, 3, 64):
        got = tblend.windowed_blend_fwd_plain(
            table, src, valid, tile, 0, 16, CONSTS, chunk_blocks=chunk
        )
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blend_refuses_grad():
    table, src, valid, tile = (torch.from_numpy(x) for x in _random_windows(42, 16))
    table.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tblend.windowed_blend_fwd(table, src, valid, tile, 0, 16, CONSTS)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
def test_kernel_matches_plain_cuda(block):
    """The CUDA kernel against its plain version on the card: gid exact,
    out within 1e-4 + 1e-5 relative (the kernel's sequential prefix sums in
    another order than the plain cumsum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    table, src, valid, tile = _random_windows(50 + block, block)
    before = tblend.windowed_blend_fwd.launches
    out_k, gid_k = _port_blend(table, src, valid, tile, 0, block, device="cuda")
    assert tblend.windowed_blend_fwd.launches == before + 1
    dev = [torch.from_numpy(x).cuda() for x in (table, src, valid, tile)]
    out_p, gid_p = tblend.windowed_blend_fwd_plain(*dev, 0, block, CONSTS)
    np.testing.assert_array_equal(gid_k, t2n(gid_p))
    np.testing.assert_allclose(out_k, t2n(out_p), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
def test_kernel_matches_first_design_cuda(block):
    """The Hopper forward against the first design on the card: gid exact,
    S_b bit for bit (both sum the same rounded log1pf terms in lane order),
    colour within 1e-4 + 1e-5 relative (the first design takes T from
    expf(S), the Hopper one by multiplication)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    table, src, valid, tile = _random_windows(60 + block, block)
    dev = [torch.from_numpy(x).cuda() for x in (table, src, valid, tile)]
    with torch.no_grad():
        out_1, gid_1 = tblend.windowed_blend_fwd_v1(*dev, 0, block, CONSTS)
        out, gid = tblend.windowed_blend_fwd(*dev, 0, block, CONSTS)
    assert torch.equal(gid, gid_1) and torch.equal(out[:, 3], out_1[:, 3])
    np.testing.assert_allclose(t2n(out), t2n(out_1), atol=1e-4, rtol=1e-5)


def _fake_nvcc(tmp_path):
    """An executable that records its call and writes its -o target."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    log = tmp_path / "calls.txt"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi\n'
        "  shift\n"
        "done\n"
    )
    nvcc.chmod(0o755)
    return nvcc, log


def test_build_uses_cuda_home_and_caches_by_content(tmp_path, monkeypatch):
    from gaussiansplatting_tpu_torch.kernels import build

    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert build.find_nvcc() == str(nvcc)

    path = build.build("blend_fwd")
    assert path.parent == tmp_path / "kernels" and path.read_text() == "lib\n"
    assert path == build.library_path("blend_fwd")
    call = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
    assert call[-1].endswith("csrc/blend_fwd.cu")
    # unchanged source: no second compile; no temporary files left behind
    assert build.build("blend_fwd") == path
    assert len(log.read_text().splitlines()) == 1
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    from gaussiansplatting_tpu_torch.kernels import build

    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    from gaussiansplatting_tpu_torch.kernels import build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build("blend_fwd")
    assert list((tmp_path / "kernels").iterdir()) == []


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    """A kernel's build is keyed by its source and by csrc/*.cuh, so an
    edited shared header rebuilds every kernel that may include it."""
    from gaussiansplatting_tpu_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != first
