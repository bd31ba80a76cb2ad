"""Which kernel ``matmul_int8`` and ``matmul_bf16`` launch on the card, and
how the decode (narrow-M) kernels split K, pinned on the CPU in pure
Python (the kernels run only on the card; ``tests/test_torch_cuda.py``
holds them against their plain versions there):

* ``route_int8``: N <= 8 on the skinny kernel; K and N multiples of 16
  with 16-byte aligned bases on the tensor cores, M <= 16 on the narrow-M
  kernel and above on the tiled one; every other shape on the dp4a tile;
* ``route_bf16``: where TMA could address the operands, M <= 16 on the
  narrow-M kernel and above on the wgmma one; else the mma.sync kernel;
* ``narrow_split``: the K steps of its splits, as each narrow kernel's
  source (``csrc/matmul.cu``) deals them, cover K exactly in the kernel's
  step, every split non-empty, at most ``NARROW_BLOCKS`` blocks, and the
  split is a function of N and K alone (a row's float sums cannot depend
  on M);
* each route's shared memory, summed from its kernel's declarations in
  ``csrc/matmul.cu``, fits the card;
* the int8 wrapper refuses an operand that requires grad before any
  check or launch, on every route's shapes.
"""
import inspect
import re
from pathlib import Path

import pytest
import torch

import torch_port_util  # noqa: F401  (torch lazy-module registries)
from repro_torch.kernels import _build
from repro_torch.kernels import matmul as km

_CU = (Path(km.__file__).parent / "csrc" / "matmul.cu").read_text()


def _constants():
    """``csrc/matmul.cu``'s ``constexpr int`` constants, each expression
    evaluated over the ones before it."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", _CU,
                                 re.M):
        env[name] = _eval(expr, env)
    return env


def _eval(expr, env):
    """A C integer expression of the source (``/`` divides integers)."""
    return eval(expr.replace("/", "//"), {"__builtins__": {}}, env)


_C = _constants()


def _kernel_source(name):
    """A kernel's text in ``csrc/matmul.cu``, from its definition to the
    next kernel (its launch functions included)."""
    start = re.search(rf"^{name}\(", _CU, re.M).start()
    end = _CU.find("__global__", start)
    return _CU[start:] if end < 0 else _CU[start:end]

_MS = (1, 8, 16, 17, 32, 4096)
# qwen3-4b's decode projections and MLP GEMMs, (K, N), and a TP 2 rank's
_LM = ((2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
       (9728, 2560), (2560, 2048), (2560, 512), (2048, 2560), (2560, 4864),
       (4864, 2560))


@pytest.mark.parametrize("m", _MS)
def test_route_int8_by_rows(m):
    want = "narrow" if m <= 16 else "tc"
    for k, n in _LM + ((2576, 1008), (16, 16)):
        assert km.route_int8(m, n, k, 0, 256) == want


@pytest.mark.parametrize("k,n,a_off,b_off,want", [
    (2561, 1003, 0, 0, "dp4a"),     # the ragged LM shape: K, N odd
    (2560, 1000, 0, 0, "dp4a"),     # N % 16
    (2568, 1024, 0, 0, "dp4a"),     # K % 16
    (2560, 1024, 4, 0, "dp4a"),     # a's base 4 bytes off 16-byte alignment
    (2560, 1024, 0, 8, "dp4a"),     # b's base 8 bytes off
    (0, 1024, 0, 0, "dp4a"),        # K = 0
    (2560, 8, 0, 0, "skinny"),      # N <= 8 whatever the rest
    (37, 5, 3, 1, "skinny"),
    (2576, 1008, 0, 0, "narrow")])  # ragged to the tiles, 16-aligned
def test_route_int8_by_shape_and_base(k, n, a_off, b_off, want):
    assert km.route_int8(8, n, k, 1024 + a_off, 2048 + b_off) == want
    if want == "narrow":
        assert km.route_int8(4096, n, k, 1024, 2048) == "tc"


@pytest.mark.parametrize("m", _MS)
def test_route_bf16_by_rows(m):
    want = "narrow" if m <= 16 else "wgmma"
    for k, n in _LM + ((200, 264), (8, 8)):
        assert km.route_bf16(m, n, k, 0, 256) == want


@pytest.mark.parametrize("k,n,a_off,b_off", [
    (2558, 9728, 0, 0), (64, 260, 0, 0), (64, 256, 2, 0), (64, 256, 0, 8),
    (0, 256, 0, 0)])
def test_route_bf16_off_tma_shapes_run_mma_sync(k, n, a_off, b_off):
    for m in (1, 8, 16, 4096):
        assert km.route_bf16(m, n, k, 512 + a_off, 4096 + b_off) == "mma.sync"


_NARROW = {"int8": "matmul_int8_narrow_kernel",
           "bf16": "matmul_bf16_narrow_kernel"}


def _kernel_step(dtype):
    """A narrow kernel's K step, read from its source, which must deal
    split s the steps ``s * steps / splits`` up to ``(s + 1) * steps /
    splits``."""
    src = _kernel_source(_NARROW[dtype])
    got = re.search(r"const int steps = \(K \+ (\d+)\) / (\d+);", src)
    assert int(got.group(1)) + 1 == int(got.group(2))
    for lo, hi in (("st0", "s"), ("st1", "s + 1")):
        assert (f"{lo} = static_cast<int>(static_cast<long long>({hi}) * "
                "steps / splits);") in src
    return int(got.group(2))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_narrow_split_covers_k_exactly(dtype):
    step = _kernel_step(dtype)
    assert step == km.NARROW_STEP[dtype]
    assert _C["NR_BN"] == km.NARROW_BN
    cap = re.search(r"if \(splits < 1 \|\| splits > (\d+)\)", _CU)
    assert int(cap.group(1)) == km.NARROW_SPLITS
    for k, n in _LM + ((2576, 1008), (16, 16), (32, 128), (9728, 64),
                       (48, 4096), (100_000, 16)):
        splits = km.narrow_split(n, k, step)
        steps = -(-k // step)
        ranges = [range(s * steps // splits, (s + 1) * steps // splits)
                  for s in range(splits)]
        assert 1 <= splits <= km.NARROW_SPLITS
        assert [i for r in ranges for i in r] == list(range(steps))
        assert all(len(r) > 0 for r in ranges)
        tiles = -(-n // km.NARROW_BN)
        assert splits == 1 or tiles * splits <= km.NARROW_BLOCKS
        # at least NARROW_MIN_STEPS steps a block where K is split at all
        assert splits == 1 or steps // splits >= km.NARROW_MIN_STEPS


def test_narrow_split_depends_on_n_and_k_only():
    assert list(inspect.signature(km.narrow_split).parameters) == [
        "n", "k", "step"]
    # qwen3-4b's decode GEMMs, as the kernels take them
    assert km.narrow_split(9728, 2560, 16) == 6      # gate, up: 456 blocks
    assert km.narrow_split(2560, 9728, 16) == 16     # down: 320 blocks
    assert km.narrow_split(1024, 2560, 32) == 10     # wk, wv: 80 blocks


_BYTES = {"int": 4, "float": 4, "__nv_bfloat16": 2, "uint64_t": 8}


@pytest.mark.parametrize("kernel,dynamic", [
    ("matmul_int8_narrow_kernel", None), ("matmul_int8_tc_kernel", "TI_SMEM"),
    ("matmul_int8_kernel", None), ("matmul_bf16_narrow_kernel", None),
    ("matmul_bf16_wgmma_kernel", "MW_SMEM"), ("matmul_bf16_kernel", None)])
def test_each_route_fits_shared_memory(kernel, dynamic):
    """A route's static shared memory (its kernel's ``__shared__`` arrays,
    two 8-row tiles where the narrow kernels have MT) fits 48 KB, and with
    the dynamic bytes its launch asks for, the card's limit."""
    src = _kernel_source(kernel)
    static = 0
    for ty, dims in re.findall(
            r"__shared__ (?:__align__\(\d+\) )?(\w+) \w+((?:\[[^\]]+\])+);",
            src):
        count = 1
        for d in re.findall(r"\[([^\]]+)\]", dims):
            count *= _eval(d, {**_C, "MT": 2})
        static += count * _BYTES[ty]
    assert static <= 48 * 1024
    extra = 0
    if dynamic:
        assert re.search(rf"allow_smem\({kernel}(<\w+>)?, {dynamic}\)", src)
        extra = _C[dynamic]
    assert 0 < static + extra <= _build.SMEM_LIMIT


def _meta(*shape, grad=True):
    return torch.empty(shape, dtype=torch.float32, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("m,k,n", [(8, 2560, 1024), (32, 2560, 1024),
                                   (8, 2561, 1003), (4096, 128, 5)])
def test_int8_wrapper_refuses_grad_before_any_launch(m, k, n):
    """An integer tensor cannot require grad, so a float one shows that
    the refusal comes first; with autograd off the call reaches the
    wrapper's own checks (a meta tensor is no CUDA tensor)."""
    counts = [getattr(km.matmul_int8, c) for c in (
        "launches", "skinny_launches", "narrow_launches", "tc_launches")]
    with pytest.raises(RuntimeError, match="requires grad"):
        km.matmul_int8(_meta(m, k), _meta(k, n))
    with torch.no_grad():
        with pytest.raises((ValueError, TypeError)):
            km.matmul_int8(_meta(m, k), _meta(k, n))
    assert counts == [getattr(km.matmul_int8, c) for c in (
        "launches", "skinny_launches", "narrow_launches", "tc_launches")]
