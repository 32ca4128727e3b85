"""The probe P1's plain versions (tdeed_tpu_torch/kernels/probe.py) against
the JAX tool's own Pallas bodies (tools/profile_pallas_probe.py:96-128) in
interpret mode, called with the specs of the tool's ``run`` (grid (H, 2),
blocks (1, W/2, C, N)), on the same bf16 inputs made with numpy.

Tolerances:
  stream, and outerp's pass-through: bit-exact (1.03125 is exact in bf16
  and a bf16 product is exact in fp32: one rounding on both sides);
  perpix: 1 bf16 ulp at the value's magnitude, floored at 2^-9. Both sum
  24 or 48 fp32 products and round once to bf16; another summation order
  can move a value across one rounding boundary. Near 0 the fp32 sums
  differ by ~1e-7 absolute, more than 1 ulp of a value that small;
  outerp's (C, C) fp32 sum: 1e-5 of its largest entry (sums of 8,192
  products per entry in another order).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tdeed_tpu.utils.profiling as jax_profiling
from tdeed_tpu_torch.kernels import probe
from tdeed_tpu_torch.tools import profile_probe
from tdeed_tpu_torch.utils import profiling
from tests.torch_port_util import assert_within_bf16_ulp, to_np

REPO = Path(__file__).resolve().parents[1]
SHAPE = (8, 8, 24, 128)
STACKED = (8, 4, 48, 128)
VARIANTS = ("stream", "perpix", "stacked2", "outerp")


@pytest.fixture(scope="module")
def tool():
    """tools/profile_pallas_probe.py, imported in interpret mode and with
    its compilation cache switched off, so the test writes no cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROBE_INTERPRET", "1")
        mp.setattr(jax_profiling, "enable_compilation_cache", lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location(
            "profile_pallas_probe", REPO / "tools" / "profile_pallas_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert mod.INTERPRET
    return mod


def _pallas(kernel, x, extra_in=None, out_shapes=()):
    """``pl.pallas_call`` of a tool body with the specs of the tool's run()
    (:131-159), in interpret mode; returns every output."""
    shape = x.shape
    grid = (shape[0], 2)
    n_rows = shape[1] // grid[1]
    blk = (1, n_rows) + shape[2:]
    in_specs, args = [], []
    if extra_in is not None:
        in_specs.append(pl.BlockSpec(extra_in.shape, lambda h, j: (0,) * extra_in.ndim))
        args.append(extra_in)
    in_specs.append(pl.BlockSpec(blk, lambda h, j: (h, j, 0, 0)))
    outs = [jax.ShapeDtypeStruct(shape, jnp.bfloat16)]
    out_specs = [pl.BlockSpec(blk, lambda h, j: (h, j, 0, 0))]
    for s, d in out_shapes:
        outs.append(jax.ShapeDtypeStruct(s, d))
        out_specs.append(pl.BlockSpec(s, lambda h, j, n=len(s): (0,) * n))
    body = (functools.partial(kernel, n_rows=n_rows)
            if "n_rows" in kernel.__code__.co_varnames else kernel)
    f = pl.pallas_call(body, grid=grid, in_specs=in_specs, out_specs=out_specs,
                       out_shape=outs, interpret=True)
    return f(*args, x)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _jax(t: torch.Tensor):
    """The same bf16 values as a JAX array (exact through fp32)."""
    return jnp.asarray(to_np(t), jnp.bfloat16)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_versions_match_the_pallas_bodies(tool, variant):
    shape = STACKED if variant == "stacked2" else SHAPE
    c = shape[2]
    x = _bf16(np.random.default_rng(0).standard_normal(shape))
    seed = 2 if variant == "stacked2" else 1
    wt = _bf16(np.random.default_rng(seed).standard_normal((c, c)) / np.sqrt(c))
    before = (probe.stream.launches, probe.perpix.launches, probe.outerp.launches)

    if variant == "stream":
        (want,) = _pallas(tool.stream_kernel, _jax(x))
        np.testing.assert_array_equal(to_np(probe.stream(x)), np.asarray(want, np.float32))
    elif variant in ("perpix", "stacked2"):
        (want,) = _pallas(tool.perpix_kernel, _jax(x), extra_in=_jax(wt))
        got = probe.perpix(x, wt)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert_within_bf16_ulp(to_np(got), np.asarray(want, np.float32), floor=2.0 ** -9)
    else:
        want, want_acc = _pallas(tool.outerp_kernel, _jax(x),
                                 out_shapes=[((c, c), jnp.float32)])
        got, acc = probe.outerp(x)
        np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
        want_acc = np.asarray(want_acc)
        assert acc.dtype == torch.float32 and acc.shape == (c, c)
        err = np.abs(acc.numpy() - want_acc).max()
        assert err <= 1e-5 * np.abs(want_acc).max(), err
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert (probe.stream.launches, probe.perpix.launches, probe.outerp.launches) == before


def test_profile_probe_tool_reports_four_variants_on_cpu(capsys):
    results = profile_probe.main(["--device", "cpu", "--shape", ",".join(map(str, SHAPE))])
    lines = capsys.readouterr().out.splitlines()
    assert [r.name for r in results] == list(VARIANTS)
    for r in results:
        report = [ln for ln in lines if ln.startswith(f"{r.name} ")]
        assert len(report) == 1, lines
        assert " ms " in report[0] and "GB/s" in report[0] and "library" in report[0]
        assert r.ms > 0 and r.library_ms > 0 and r.bound_by == "bytes"
        assert r.top_ops == []  # no device trace on the cpu
    assert results[2].shape == STACKED
    assert sum(" matmul delta: " in ln for ln in lines) == 3


def test_bounds_at_the_tool_shape():
    """The bound rows of PERF.md: 963.4 MB moved (0.288 ms) for each
    variant at (112, 112, 24, 800), 11.56 GFLOP per perpix call."""
    h, w, c, n = profile_probe.SHAPE
    moved = 2 * h * w * c * n * 2
    assert moved == 963_379_200
    ms, by = profiling.bound(moved, 2 * h * w * c * c * n, profiling.PEAK_BF16_FLOPS)
    assert by == "bytes" and abs(ms - 0.28757) < 1e-4
    ms, by = profiling.bound(0, 11.56e9, profiling.PEAK_FP32_FLOPS)
    assert by == "operations" and abs(ms - 0.17254) < 1e-4


def _x(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "x,wt,error",
    [
        (_x((8, 24, 16)), None, ValueError),  # rank
        (_x((2, 2, 8, 16), torch.float32), None, TypeError),  # dtype
        (_x((2, 2, 65, 16)), None, ValueError),  # C > 64
        (_x((2, 2, 8, 0)), None, ValueError),  # empty
        (_x((2, 2, 8, 16)).transpose(0, 1), None, ValueError),  # strided
        (_x((2, 2, 8, 16)), _x((8, 9)), ValueError),  # weight not (C, C)
        (_x((2, 2, 8, 16)), _x((8, 8), torch.float32), ValueError),  # weight dtype
        (_x((2, 2, 8, 16)), _x((8, 16))[:, ::2], ValueError),  # weight strided
        (_x((2, 2, 8, 16)), torch.zeros(8, 8, dtype=torch.bfloat16, device="meta"),
         ValueError),  # devices differ
    ],
    ids=["rank", "dtype", "C>64", "empty", "strided", "weight-shape", "weight-dtype",
         "weight-strided", "devices"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(x, wt, error):
    """The checks the CUDA wrappers run before a launch."""
    with pytest.raises(error):
        probe._check(x, wt)
    probe._check(_x((2, 2, 8, 16)), _x((8, 8)))  # a valid pair passes


PLAN_NS = (1, 7, 8, 9, 15, 16, 17, 37, 129, 160, 161, 320, 800, 801, 1000, 4099)


def _plan_smem(c_pad, bn):
    """csrc/probe.cu:perpix_smem: the weight, a ring of three tiles and an
    output tile, each (c_pad, bn + 8) bf16."""
    return 2 * c_pad * c_pad + 2 * (3 + 1) * c_pad * (bn + 8)


@pytest.mark.parametrize("n", PLAN_NS)
def test_perpix_plan_fits_the_card_for_every_c(n):
    """For every C <= 64: C padded to the next multiple of 16, tiles that
    are multiples of 16 with none empty, one block's shared memory within
    227 KB, the fewest such tiles, one block per SM or per item."""
    for c in range(1, probe.MAX_C + 1):
        for npix in (1, 5, 12544):
            p = probe.perpix_plan(c, n, npix)
            assert p.c_pad % 16 == 0 and c <= p.c_pad < c + 16
            assert p.bn % 16 == 0 and p.bn >= 16
            assert (p.tiles - 1) * p.bn < n <= p.tiles * p.bn
            assert p.smem_bytes == _plan_smem(p.c_pad, p.bn) <= probe.BLOCK_SHARED_MAX
            assert p.grid == min(npix * p.tiles, probe.H100_SMS)
            if p.tiles > 1:  # the fewest tiles: the width of one fewer does not fit
                bn = -(-(-(-n // (p.tiles - 1))) // 16) * 16
                assert _plan_smem(p.c_pad, bn) > probe.BLOCK_SHARED_MAX


def _assert_covers_every_pixel_and_column_once(p):
    n, npix = p.n, p.npix
    items = npix * p.tiles
    hits = np.zeros((npix, n), np.int32)
    ends = []
    for b in range(p.grid):
        lo_item, hi_item = items * b // p.grid, items * (b + 1) // p.grid
        assert hi_item > lo_item  # no block without work
        ends.append((lo_item, hi_item))
        for item in range(lo_item, hi_item):
            pix, tile = divmod(item, p.tiles)
            lo, hi = tile * p.bn, min(n, (tile + 1) * p.bn)
            assert 0 < hi - lo <= p.bn
            hits[pix, lo:hi] += 1
    assert ends[0][0] == 0 and ends[-1][1] == items
    assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))  # contiguous, in order
    assert (hits == 1).all()


PLAN_COVER_CASES = [(24, 800, 1), (48, 800, 3), (1, 1, 1), (17, 37, 600), (64, 801, 700),
                    (33, 9, 2000), (24, 160, 1000), (15, 129, 64), (16, 1904, 300),
                    (64, 4099, 5)]


@pytest.mark.parametrize(
    "c,n,npix",
    PLAN_COVER_CASES,
)
def test_perpix_plan_covers_every_pixel_and_column_once(c, n, npix):
    """The blocks' item ranges, taken as the kernel takes them (block b:
    items [items * b // grid, items * (b + 1) // grid), item i: pixel
    i // tiles, columns from (i % tiles) * bn), cover each (pixel, column)
    of the output exactly once."""
    _assert_covers_every_pixel_and_column_once(probe.perpix_plan(c, n, npix))


def test_perpix_plan_at_the_tool_shapes():
    """The plans the probe tool runs, one block per SM: at C = 24 a whole
    pixel per tile (204 KB of shared memory), at the stacked C = 48 half a
    pixel (158 KB)."""
    p24 = probe.perpix_plan(24, 800, 112 * 112)
    assert (p24.c_pad, p24.bn, p24.tiles, p24.smem_bytes, p24.grid) == (32, 800, 1, 208_896, 132)
    p48 = probe.perpix_plan(48, 800, 112 * 56)
    assert (p48.c_pad, p48.bn, p48.tiles, p48.smem_bytes, p48.grid) == (48, 400, 2, 161_280, 132)
    assert probe.perpix_plan(16, 8, 1).smem_bytes <= 48 * 1024  # no opt-in attribute needed
    assert probe.perpix_plan(24, 800, 10, sms=4).grid == 4
    with pytest.raises(ValueError):
        probe.perpix_plan(65, 800, 1)
    with pytest.raises(ValueError):
        probe.perpix_plan(24, 0, 1)
    with pytest.raises(ValueError):
        probe.perpix_plan(24, 800, 0)
    with pytest.raises(ValueError):  # 2^32 work items
        probe.perpix_plan(1, 2048 * 2**12, 2**20)


def _outerp_smem(c_pad, bn):
    """csrc/probe.cu:outerp_smem: a ring of three (c_pad, bn + 8) bf16
    tiles and the block's (c_pad, c_pad) fp32 sum."""
    return 2 * 3 * c_pad * (bn + 8) + 4 * c_pad * c_pad


@pytest.mark.parametrize("n", PLAN_NS)
def test_outerp_plan_fits_the_card_for_every_c(n):
    """For every C <= 64: C padded to the next multiple of 16, tiles that
    are multiples of 16 with none empty, one block's shared memory within
    227 KB, the fewest such tiles, one block per SM or per item."""
    for c in range(1, probe.MAX_C + 1):
        for npix in (1, 5, 12544):
            p = probe.outerp_plan(c, n, npix)
            assert p.c_pad % 16 == 0 and c <= p.c_pad < c + 16
            assert p.bn % 16 == 0 and p.bn >= 16
            assert (p.tiles - 1) * p.bn < n <= p.tiles * p.bn
            assert p.smem_bytes == _outerp_smem(p.c_pad, p.bn) <= probe.BLOCK_SHARED_MAX
            assert p.grid == min(npix * p.tiles, probe.H100_SMS)
            if p.tiles > 1:  # the fewest tiles: the width of one fewer does not fit
                bn = -(-(-(-n // (p.tiles - 1))) // 16) * 16
                assert _outerp_smem(p.c_pad, bn) > probe.BLOCK_SHARED_MAX


@pytest.mark.parametrize("c,n,npix", PLAN_COVER_CASES)
def test_outerp_plan_covers_every_pixel_and_column_once(c, n, npix):
    """outerp's blocks take their items as perpix's do: each (pixel, column)
    of x is staged, passed through and summed exactly once."""
    _assert_covers_every_pixel_and_column_once(probe.outerp_plan(c, n, npix))


def test_outerp_plan_at_the_tool_shape():
    """The plan the probe tool runs, one block per SM: a whole pixel per
    tile at C = 24 (155,136 B of ring and 4,096 B of sum); the stacked
    C = 48 would take two tiles a pixel, as C = 64 does."""
    p = probe.outerp_plan(24, 800, 112 * 112)
    assert (p.c_pad, p.bn, p.tiles, p.smem_bytes, p.grid) == (32, 800, 1, 159_232, 132)
    p48 = probe.outerp_plan(48, 800, 112 * 56)
    assert (p48.c_pad, p48.bn, p48.tiles, p48.smem_bytes, p48.grid) == (48, 400, 2, 126_720, 132)
    assert probe.outerp_plan(64, 800, 3).tiles == 2
    assert probe.outerp_plan(16, 8, 1).smem_bytes <= 48 * 1024  # no opt-in attribute needed
    assert probe.outerp_plan(24, 800, 10, sms=4).grid == 4
    for bad in ((65, 800, 1), (0, 800, 1), (24, 0, 1), (24, 800, 0)):
        with pytest.raises(ValueError, match="outerp"):
            probe.outerp_plan(*bad)
    with pytest.raises(ValueError):  # 2^32 work items
        probe.outerp_plan(1, 2048 * 2**12, 2**20)


@pytest.mark.parametrize("fn", [probe.stream, probe.outerp, lambda x: probe.perpix(x, x[0, 0])])
def test_wrappers_refuse_devices_other_than_cuda_and_cpu(fn):
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(torch.zeros(2, 2, 8, 8, dtype=torch.bfloat16, device="meta"))
