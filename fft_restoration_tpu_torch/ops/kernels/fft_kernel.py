"""FFT kernel family (B1/B3/B6, B11) — wrappers and plain versions.

Counterpart of fft_restoration_tpu/ops/pallas/fft_kernel.py. The three
TPU kernels that share the `_run_stages` body run in two CUDA kernels on
one stage-group engine (csrc/fft_groups.cuh: the radix-2 stages in
register groups of <= 4, 16 complex values a thread): every pass with
the transposed store (B1, `_fft_rows_transposed`) in csrc/fft_rows_t.cu
after the plan `t_plan` computes here; the row-major passes, the plain
row pass (B6, `fft_rows_pallas`, both orderings) and the final
packed-output inverse with min/max partials (B3, `fft_rows_packed_out`),
in csrc/fft_rows.cu after `r_plan`; the spectral middles B2, B7 and B10
(ops/kernels/wiener_spectral.py) run on the same engine after `s_plan`.
A plan holds the stage groups, the thread-to-element map and the padded
shared rows; `t_slot_index` and `t_cross_columns` give its element map,
which the CPU tests emulate.
`fft_cols` (csrc/fft_cols.cu) is B11, `fft_cols_pallas`: the same stages
down the columns in register groups, after the plan `col_plan`
computes here (strips of columns, the swizzled shared rows).

The pipeline's ordering is revorder: the forward transform is DIF
(natural in, bit-reversed out), the inverse DIT (bit-reversed in,
natural out), unscaled. `ordering="natural"` (B6's and B11's natural
mode, pow2 lengths) bit-reverses the input and runs the DIT stages with
the direction's tables: natural in and out.

Two engines, the JAX package's `engine=` (`resolve_engine`):
  roll  (the port's default) pure radix-2 stages; spectra in plain
        bit-reversed order.
  mxu   (the JAX default) on a revorder pass whose pow2 length (or pow2
        tail q) is >= 128: the outer stages S-1 .. 7 as radix-2 groups,
        then one natural-order DFT-128 of every contiguous 128-point
        group (`group_dft_plain`; on the card the tensor cores,
        csrc/fft_group_dft.cuh, and in B1, B3 and B6 with the tables
        resident in shared memory, csrc/fft_group_dft_smem.cuh); the
        inverse mirrors it. Spectra land in
        the "hybrid order" (`hybrid_permutation`). `precision=`
        'default' rounds the group product's operands to bf16 (one bf16
        pass, f32 sums), 'highest' keeps float32 (3xTF32 on the card).
        Shorter or natural-order passes resolve to roll, as in JAX.
B1, B3 and B6 take `engine=` and `precision=`; B2 and B7
(wiener_spectral.py) too. A spectrum is only valid with the engine
(and, for mxu, the precision) that made it.

Mixed radix (`radices`, the --pad smooth extents): a row of n =
prod(radices) * 2^k points first runs one cross-DFT level per odd radix
(3 or 5), each an r-point DFT across the row's q-wide sub-blocks and a
four-step twiddle plane (the JAX _mixed_cross_fwd), then the DIF stages
over the pow2 tail; the inverse runs the DIT stages, then the levels
innermost first (_mixed_cross_inv). The spectrum is then in residue-block
order, bit-reversed inside each block (in the hybrid order inside each
block at mxu): diff it only against the JAX engine of the same name with
the same radices.

bf16 staging (`stage_dtype`, models/pipeline.py; the JAX out_dtype and
_load_f32): B1's forward pass stores bfloat16 planes with
`out_dtype=torch.bfloat16` (`fft_rows(..., transposed=True)`,
`fft_rows_stack`), rounded to nearest even; B6's revorder passes and B3
read bfloat16 planes, widened as they load. Every kernel computes in
float32, and so does every plain version (it widens its input and rounds
its output the same way). Such a launch is counted under
"<kernel>_bf16" too (`STAGE_COUNTS`).

`fft_rows_stack` is B1 over a (B, h, w, C) image stack: the kernel's
loader maps logical plane q to image q // C, channel q % C, so channel
pairs straddle images (the JAX batched graph's (B*3, hp, wp) packing)
and the stack streams in with no permute copy.

Each wrapper takes its plain version (`*_plain`, the same DIF/DIT stage
loop on tensors with the same float64-built tables) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda, u8_to_unit

# shared memory for the rows of one of B3's min/max partials
# (rows_per_block: 4 at n = 2048), which a packed-store block of B3 holds
# (r_plan); the kernels' other blocks take their rows from their plans
ROWS_SMEM_BUDGET = 64 << 10
# one complex float32 row must fit a block's shared memory (227 KB on
# Hopper): the kernels take rows of at most 16384 points
MAX_KERNEL_N = 16384
MAX_BLOCK_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _twiddle_planes_np(n: int, inverse: bool, q: int | None = None) -> tuple:
    """(S, N) cos/sin planes; lane j of stage s = w_{L}^{j mod L/2},
    L = 2^{s+1}, computed in float64 (copied from the JAX package).
    q: only the log2(q) stages of the pow2 tail of an n = prod(radices)
    * q transform; L divides q divides n, so the width-n planes serve
    the q-local butterflies of every q-block."""
    stages = (q or n).bit_length() - 1
    sign = 1.0 if inverse else -1.0
    cos = np.empty((stages, n), np.float32)
    sin = np.empty((stages, n), np.float32)
    j = np.arange(n, dtype=np.float64)
    for s in range(stages):
        length = 2 << s
        k = np.mod(j, length // 2)
        ang = sign * 2.0 * math.pi * k / length
        cos[s] = np.cos(ang).astype(np.float32)
        sin[s] = np.sin(ang).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def _half_masks_np(n: int, q: int | None = None) -> np.ndarray:
    """(S, N) float32 mask: 1.0 where lane j is in the first half of its
    stage-s butterfly block, else 0.0 (copied from the JAX package).
    q: the pow2 tail of a mixed-radix n (see _twiddle_planes_np)."""
    stages = (q or n).bit_length() - 1
    j = np.arange(n)
    out = np.empty((stages, n), np.float32)
    for s in range(stages):
        length = 2 << s
        out[s] = ((j % length) < length // 2).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _cross_planes_np(n: int, radices: tuple, inverse: bool) -> tuple:
    """(L, N) cos/sin twiddle planes of the mixed-radix cross-DFT levels
    (copied from the JAX package). Level l splits each w-wide block
    (w = n / prod(radices[:l])) into r = radices[l] sub-blocks of width
    q = w / r; the four-step twiddle of output sub-block k1, lane offset
    j2 is W_w^{k1*j2}: as a width-n plane tw[j] = W_w^{((j mod w) // q) *
    (j mod q)}."""
    sign = 1.0 if inverse else -1.0
    cos = np.empty((len(radices), n), np.float32)
    sin = np.empty((len(radices), n), np.float32)
    j = np.arange(n, dtype=np.int64)
    w = n
    for lvl, r in enumerate(radices):
        q = w // r
        k1 = (j % w) // q
        j2 = j % q
        ang = sign * 2.0 * math.pi * (k1 * j2).astype(np.float64) / w
        cos[lvl] = np.cos(ang).astype(np.float32)
        sin[lvl] = np.sin(ang).astype(np.float32)
        w = q
    return cos, sin


@functools.lru_cache(maxsize=None)
def _cross_coefs_np(r: int, inverse: bool) -> tuple:
    """The r-point DFT's coefficients W_r^{sign*m}, m < r, as float32 of
    float64 angles (the JAX _cross_dft_level's np.float32(math.cos(ang)))."""
    sign = 1.0 if inverse else -1.0
    angs = [sign * 2.0 * math.pi * m / r for m in range(r)]
    return (np.array([math.cos(a) for a in angs], np.float32),
            np.array([math.sin(a) for a in angs], np.float32))


def _mixed_q(n: int, radices: tuple) -> int:
    """Validate an n = prod(radices) * q mixed-radix split; return the
    pow2 tail q (the JAX package's errors)."""
    q = n
    for r in radices:
        if r < 2 or q % r:
            raise ValueError(
                f"radices {radices} do not divide the transform length {n}"
            )
        q //= r
    if q < 2 or q & (q - 1):
        raise ValueError(
            f"mixed-radix length {n} / radices {radices} leaves a "
            f"non-power-of-two tail {q}"
        )
    return q


# ---------------------------------------------------------------------------
# The MXU engine (JAX fft_kernel.py:279-451): the outer radix-2 stages and
# one DFT-128 matrix product per contiguous 128-point group.

MXU_INNER = 128
MXU_LOG = 7
ENGINES = ("roll", "mxu", "auto")
ENGINE_CHOICES = ("roll", "mxu")  # the pipelines', CLI's and server's (the JAX CLI's)
MXU_PRECISIONS = ("default", "highest")


@functools.lru_cache(maxsize=None)
def _dft_planes_np(length: int, inverse: bool) -> tuple:
    """(length, length) cos/sin planes of the DFT matrix
    W[l, k] = exp(sign * 2*pi*i * l * k / length), float64-computed
    (copied from the JAX package)."""
    sign = 1.0 if inverse else -1.0
    lk = np.outer(np.arange(length, dtype=np.float64), np.arange(length))
    ang = sign * 2.0 * math.pi * lk / length
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def resolve_engine(engine: str, n: int, ordering: str, q: int | None = None) -> str:
    """The JAX _resolve_engine: 'mxu' needs revorder ordering and a pow2
    (sub-)extent (q, the pow2 tail of a mixed-radix n; n itself when
    None) >= 128, else it resolves to 'roll'; 'auto' is mxu where
    eligible."""
    if engine not in ENGINES:
        raise ValueError(f"unknown FFT engine {engine!r}")
    if engine == "roll":
        return "roll"
    eligible = ordering == "revorder" and (q or n) >= MXU_INNER
    return "mxu" if eligible else "roll"


def check_precision(precision: str) -> str:
    if precision not in MXU_PRECISIONS:
        raise ValueError(f"unknown MXU precision {precision!r}; one of {MXU_PRECISIONS}")
    return precision


def pass_engine(engine: str, n: int, radices: tuple = (), ordering: str = "revorder") -> str:
    """The resolved engine of one length-n pass (radices: its cross levels)."""
    radices = tuple(radices)
    return resolve_engine(engine, n, ordering, _mixed_q(n, radices) if radices else None)


def engine_code(engine: str, n: int, radices: tuple = (), ordering: str = "revorder",
                precision: str = "default") -> int:
    """The C entries' engine of a pass: 0 the radix-2 stages (roll), 1 the
    group DFT in bf16 ('default'), 2 in 3xTF32 ('highest')
    (csrc/fft_group_dft.cuh ENG_*)."""
    check_precision(precision)
    if pass_engine(engine, n, radices, ordering) == "roll":
        return 0
    return 1 if precision == "default" else 2


def hybrid_permutation(n: int) -> np.ndarray:
    """pos such that the mxu forward pass of a pow2 n puts DFT bin k at
    position pos[k] = rev_b(k mod G) * 128 + k div G, G = n / 128, b =
    log2 G (the JAX tests' hybrid_permutation)."""
    g_count = n // MXU_INNER
    k = np.arange(n)
    return brev_columns(k % g_count, g_count.bit_length() - 1) * MXU_INNER + k // g_count


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _dft_operands(inverse: bool, precision: str, device: torch.device) -> tuple:
    """(Wc, Ws, Wc + Ws) float32 on `device` as the group product takes
    them: Wc + Ws summed in float32, all three rounded to bf16 for
    'default'."""
    wc, ws = (torch.from_numpy(a) for a in _dft_planes_np(MXU_INNER, inverse))
    mats = (wc, ws, wc + ws)
    if precision == "default":
        mats = tuple(_bf16(w) for w in mats)
    return tuple(w.to(device) for w in mats)


def group_dft_plain(x_re, x_im, inverse: bool, precision: str = "default"):
    """Each contiguous 128-point group of the last axis times the DFT-128
    matrix: the JAX _group_dft_matmul's three real products,
    m1 = xr Wc, m2 = xi Ws, m3 = (xr + xi)(Wc + Ws), yr = m1 - m2,
    yi = m3 - m1 - m2. 'highest': float32 products (TF32 off on the
    card). 'default': xr, xi, xr + xi and the tables rounded to bf16
    first, then the same float32 products (the one bf16 pass of the
    card's kernels; the JAX package on a CPU ignores the precision)."""
    from fft_restoration_tpu_torch.ops.fft import _full_float32

    wc, ws, wcs = _dft_operands(bool(inverse), check_precision(precision), x_re.device)
    shape = x_re.shape
    xr = x_re.reshape(-1, MXU_INNER)
    xi = x_im.reshape(-1, MXU_INNER)
    xs = xr + xi
    if precision == "default":
        xr, xi, xs = _bf16(xr), _bf16(xi), _bf16(xs)
    with _full_float32(xr):
        m1, m2, m3 = xr @ wc, xi @ ws, xs @ wcs
    return (m1 - m2).reshape(shape), (m3 - m1 - m2).reshape(shape)


# the fragment layout of csrc/fft_group_dft.cuh: per (bin tile, k step,
# table, lane) the A operand's elements as (row, column) offsets from
# (16 mt + lane / 4, k0 + c * (lane % 4)); 'default': m16n8k16 bf16
# (k0 = 16 kt, c = 2), 'highest': m16n8k8 tf32 (k0 = 8 kt, c = 1)
_FRAG = {
    "default": (8, 16, 2, (0, 0, 8, 8, 0, 0, 8, 8), (0, 1, 0, 1, 8, 9, 8, 9)),
    "highest": (16, 8, 1, (0, 8, 0, 8), (0, 0, 4, 4)),
}


def dft_fragment_index(precision: str) -> tuple:
    """(row, column) of the A operand (bins x positions) of every fragment
    element, each of shape (8 bin tiles, k steps, 32 lanes, elements)."""
    steps, kw, c, ro, co = _FRAG[check_precision(precision)]
    mt = np.arange(8)[:, None, None, None]
    kt = np.arange(steps)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    row = 16 * mt + (lane >> 2) + np.array(ro)
    col = kw * kt + c * (lane & 3) + np.array(co)
    return row, col


@functools.lru_cache(maxsize=None)
def dft_fragments_np(inverse: bool, precision: str) -> np.ndarray:
    """The group DFT's A fragments in the kernels' order [bin tile][k
    step][table Wc, Ws, Wc + Ws][lane][element]: bf16 bit patterns
    (uint16) for 'default', float32 for 'highest' (split into tf32 parts
    in the kernel). A[bin][pos] = W[pos][bin], the tables of
    _dft_operands."""
    row, col = dft_fragment_index(precision)
    mats = _dft_operands(bool(inverse), precision, torch.device("cpu"))
    frags = torch.stack([w.T[torch.from_numpy(row), torch.from_numpy(col)] for w in mats], 2)
    if precision == "default":
        return frags.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return frags.numpy()


@functools.lru_cache(maxsize=None)
def dft_fragments(inverse: bool, precision: str, device: torch.device) -> torch.Tensor:
    """dft_fragments_np on `device`, uploaded once."""
    a = dft_fragments_np(bool(inverse), precision)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).to(device)


# B1's and B3/B6's group DFT (csrc/fft_group_dft_smem.cuh) with its tables
# resident in shared memory: 'default' the fragment tables above; 'highest'
# the symmetric form, Wc and Ws over the columns 0 .. 16 * DFT_SYM_TILES - 1
# (bins 0 .. 64 used, 65 .. 127 their mirror images), m16n8k8 tf32 fragments.
# Both are laid out in chunks of one bin tile and k step
DFT_SYM_TILES = 5
DFT_RES_CHUNKS = {"default": 8 * 8, "highest": DFT_SYM_TILES * 16}
DFT_RES_CHUNK_BYTES = {"default": 3 * 32 * 16, "highest": 2 * 32 * 16}
DFT_RES_BYTES = {p: DFT_RES_CHUNKS[p] * DFT_RES_CHUNK_BYTES[p] for p in DFT_RES_CHUNKS}
DFT_RES_BAR = 16  # the mbarrier's slot after the tables
DFT_TASK = 8  # groups a warp task (the mma's N)


@functools.lru_cache(maxsize=None)
def dft_sym_fragments_np(inverse: bool) -> np.ndarray:
    """The symmetric 'highest' tables in the kernel's order [bin tile <
    DFT_SYM_TILES][k step < 16][table Wc, Ws][lane][element] (float32):
    A[bin][pos] = W[pos][bin] for bins 0 .. 79, the float64-built
    _dft_planes_np(128) values as they are (no other rounding)."""
    row, col = dft_fragment_index("highest")
    row, col = row[:DFT_SYM_TILES], col[:DFT_SYM_TILES]
    return np.stack([w.T[row, col] for w in _dft_planes_np(MXU_INNER, bool(inverse))], 2)


@functools.lru_cache(maxsize=None)
def dft_res_tables(inverse: bool, precision: str, device: torch.device) -> torch.Tensor:
    """One direction's resident tables (DFT_RES_BYTES[precision] bytes) on
    `device`, uploaded once: dft_fragments at 'default', the symmetric
    dft_sym_fragments_np at 'highest'."""
    if check_precision(precision) == "default":
        return dft_fragments(bool(inverse), precision, device)
    return torch.from_numpy(dft_sym_fragments_np(bool(inverse))).to(device)


def dft_res_chunks(precision: str, smem_bytes: int) -> int:
    """The table chunks that fit beside a plan's shared rows (1 KB left
    for static shared memory), the count the launch passes to the kernel
    (csrc/fft_group_dft_smem.cuh DftRes): all of them but at 'default'
    beside 8 rows of 2048 points, 4 of 4096 or one of 16384 (62 of 64: the
    kernels read the last two from global memory)."""
    room = MAX_BLOCK_SMEM - DFT_RES_BAR - 1024 - smem_bytes
    return max(0, min(DFT_RES_CHUNKS[check_precision(precision)],
                      room // DFT_RES_CHUNK_BYTES[precision]))


def resident_route(code: int, inverse: bool) -> bool:
    """Whether a B1, B3 or B6 pass at an engine code runs the group DFT
    with resident tables: every tensor-core pass but the forward ones at
    'default', which keep the L2 design's kernels (csrc/fft_rows_t.cu
    fft_rows_t_l2_kernel, csrc/fft_rows.cu fft_rows_l2_kernel: the tables
    read through L1 and L2), faster there on an H100."""
    return bool(code) and not (code == 1 and not inverse)


def res_chunks(code: int, plan, inverse: bool) -> int:
    """The table chunks a pass's launch copies into shared memory at an
    engine code (0 at roll and off the resident route): the kernels take
    the count as it is and check it against their tables."""
    if not resident_route(code, inverse):
        return 0
    return dft_res_chunks(MXU_PRECISIONS[code - 1], plan.smem_bytes)


def dft_res_pointer(code: int, inverse: bool, device) -> int:
    """The resident tables' device pointer of an engine code (0: none)."""
    if not code:
        return 0
    return dft_res_tables(bool(inverse), MXU_PRECISIONS[code - 1], device).data_ptr()


# B2's and B7's group DFT (csrc/fft_group_dft_smem.cuh group_dft_sym): one
# table, resident in shared memory, serves both directions and both
# halves of the bins: the forward direction's c = Wc and s = Ws over the
# columns 0 .. 63 (bins 65 .. 127 their mirrors, bin 64 from plain sums) in
# chunks of one bin tile and k step. 'highest' the float32 c, s of the
# first DFT_HALF_TILES tiles of dft_sym_fragments_np; 'default' four bf16
# tables c, s, c + s, c - s (m16n8k16 fragments), each sum taken in float32
# and then rounded as _dft_operands rounds Wc + Ws: c + s is the forward
# direction's, c - s the inverse direction's third table.
DFT_HALF_TILES = 4
DFT_HALF_BYTES = DFT_HALF_TILES * 16 * 2 * 32 * 16  # 64 KB at both precisions


@functools.lru_cache(maxsize=None)
def dft_half_default_fragments_np() -> np.ndarray:
    """The 'default' B2/B7 table in the kernels' order [bin tile <
    DFT_HALF_TILES][k step < 8][table c, s, c + s, c - s][lane][element]:
    bf16 bit patterns (uint16), A[bin][pos] = W[pos][bin] of the forward
    direction's planes, the sums in float32 before the rounding."""
    row, col = dft_fragment_index("default")
    row, col = row[:DFT_HALF_TILES], col[:DFT_HALF_TILES]
    wc, ws = (torch.from_numpy(a) for a in _dft_planes_np(MXU_INNER, False))
    mats = (wc, ws, wc + ws, wc - ws)
    frags = torch.stack([w.T[torch.from_numpy(row), torch.from_numpy(col)] for w in mats], 2)
    return frags.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


@functools.lru_cache(maxsize=None)
def dft_half_tables(precision: str, device: torch.device) -> torch.Tensor:
    """B2's and B7's table (DFT_HALF_BYTES) on `device`, uploaded once:
    dft_half_default_fragments_np at 'default', the first DFT_HALF_TILES
    tiles of the forward dft_sym_fragments_np at 'highest'."""
    if check_precision(precision) == "default":
        return torch.from_numpy(dft_half_default_fragments_np().view(np.int16)).to(device)
    return torch.from_numpy(dft_sym_fragments_np(False)[:DFT_HALF_TILES].copy()).to(device)


def group_dft_res_tasks(groups: int, warps: int) -> dict:
    """The warp tasks of csrc/fft_group_dft_smem.cuh group_dft_res over a
    block's `groups` groups: {warp: the first group of each of its tasks};
    warp w takes the 8 groups from 8 w, 8 (w + warps), ... and all their
    bins."""
    return {w: list(range(DFT_TASK * w, groups, DFT_TASK * warps)) for w in range(warps)}


def group_dft_res_bins(precision: str, tile: int) -> tuple:
    """The bins a task's bin tile writes of each of its groups: the 16
    columns 16 * tile .. 16 * tile + 15 ('default'); 'highest' those of
    them up to 64 and the mirror 128 - k of those in 1 .. 63."""
    cols = range(16 * tile, 16 * tile + 16)
    if check_precision(precision) == "default":
        return tuple(cols)
    half = MXU_INNER // 2
    return tuple(k for k in cols if k <= half) + tuple(MXU_INNER - k for k in cols
                                                        if 0 < k < half)


def stage_spec(stages: int, mxu: bool = False) -> tuple:
    """The radix-2 stage groups of a pass of `stages` stages: all of them
    (t_stage_groups), or the mxu engine's outer stages 7 .. stages - 1
    (none at q = 128)."""
    if not mxu:
        return t_stage_groups(stages)
    outer = stages - MXU_LOG
    if outer < 0:
        raise ValueError(f"the mxu engine needs q >= {MXU_INNER}, got 2^{stages}")
    return tuple((s_lo + MXU_LOG, k) for s_lo, k in t_stage_groups(outer)) if outer else ()


def check_length(n: int, radices: tuple = ()) -> int:
    """The radix-2 stage count of a length-n transform: log2(n) for a
    power of two (radices ()), log2(q) for n = prod(radices) * q."""
    if radices:
        return _mixed_q(n, tuple(radices)).bit_length() - 1
    if n < 2 or n & (n - 1):
        raise ValueError(f"power-of-two transform length >= 2 required, got {n}")
    return n.bit_length() - 1


class Tables(NamedTuple):
    """Stage tables (S, N) and, for radices, cross planes (L, N)."""

    cos: torch.Tensor
    sin: torch.Tensor
    mask: torch.Tensor
    xcos: torch.Tensor | None
    xsin: torch.Tensor | None


@functools.lru_cache(maxsize=None)
def tables(n: int, inverse: bool, device: torch.device, radices: tuple = ()) -> Tables:
    """Float32 tables on `device`, uploaded once per (n, inverse, device,
    radices): the stage planes over the pow2 tail and the cross planes."""
    q = _mixed_q(n, radices) if radices else None
    cos, sin = _twiddle_planes_np(n, inverse, q)
    xcos, xsin = _cross_planes_np(n, radices, inverse) if radices else (None, None)
    return Tables(*(None if a is None else torch.from_numpy(a).to(device)
                    for a in (cos, sin, _half_masks_np(n, q), xcos, xsin)))


# the CUDA kernels' cross levels (csrc/fft_common.cuh radix_code): the
# smooth pads' odd factors 3, 5, 9 = (3, 3) and 15 = (3, 5), each tuple a
# compiled instance. The plain versions take any radices, as the JAX
# package.
KERNEL_RADIX_TUPLES = ((3,), (5,), (3, 3), (3, 5))
MAX_CROSS_LEVELS = 2


@functools.lru_cache(maxsize=None)
def _cross_plan_host(radices: tuple, inverse: bool) -> tuple:
    """(levels, int32 radix array, float32 coefficient array) for the C
    entries: per level 5 cos then 5 sin values of _cross_coefs_np."""
    if radices and radices not in KERNEL_RADIX_TUPLES:
        raise ValueError(
            f"the CUDA kernels take the radix tuples {KERNEL_RADIX_TUPLES}, got radices "
            f"{radices}"
        )
    rad = np.zeros(MAX_CROSS_LEVELS, np.int32)
    coef = np.zeros((MAX_CROSS_LEVELS, 2, 5), np.float32)
    for lvl, r in enumerate(radices):
        rad[lvl] = r
        coef[lvl, 0, :r], coef[lvl, 1, :r] = _cross_coefs_np(r, inverse)
    return len(radices), rad, coef


def cross_args(n: int, radices: tuple, inverse: bool, device) -> tuple:
    """The five C arguments of one direction's cross levels: levels, host
    pointers to the radices and coefficients (kept alive by the cache),
    device pointers to the (L, n) twiddle planes (0 without radices)."""
    levels, rad, coef = _cross_plan_host(tuple(radices), bool(inverse))
    if not levels:
        return 0, None, None, None, None
    t = tables(n, bool(inverse), device, tuple(radices))
    return (levels, rad.ctypes.data, coef.ctypes.data, t.xcos.data_ptr(),
            t.xsin.data_ptr())


def rows_per_block(n: int, m: int) -> int:
    """Rows a kernel block holds: the largest power of two <= 16 that fits
    ROWS_SMEM_BUDGET and the plane height."""
    r = max(1, min(16, ROWS_SMEM_BUDGET // (8 * n), m))
    return 1 << (r.bit_length() - 1)


def check_kernel_length(n: int) -> None:
    if n > MAX_KERNEL_N:
        raise ValueError(
            f"transform length {n} exceeds the kernels' shared-memory row "
            f"limit of {MAX_KERNEL_N} points"
        )


# ---------------------------------------------------------------------------
# B1's plan (csrc/fft_rows_t.cu): the radix-2 stages in groups held in
# registers. The kernel mirrors the index math below; the CPU tests run
# it group by group against run_stages.

T_SLOTS = 16            # complex values a thread holds
T_MAX_K = 4             # stages a group runs in registers (T_SLOTS = 2^T_MAX_K)
T_MAX_GROUPS = 6        # csrc/fft_rows_t.cu GroupPlan
T_THREADS = 512         # the kernel's __launch_bounds__
T_SMEM_BUDGET = 160 << 10  # one block an SM: 8 rows at n = 2048 and 2304, 4 at 3840/4096
T_MAX_ROWS = 256
T_MIN_ROWS_STORE = 8    # 32-byte column segments of the transposed store (n <= 2304)
# blocks a launch should have, per SM of the card: fewer rows a block (at
# least T_MIN_ROWS_STORE) when the rows of all pairs would give fewer
T_MIN_WAVES = 2
# the MXU instances' shared rows (csrc/fft_group_dft_smem.cuh): a block's
# shared memory less 60 of the 64 'default' table chunks (all of the 80 KB
# at 'highest'), the mbarrier and the static min/max scratch, which the
# plans' padded-row bound meets with B1's 8 rows at n = 2048 (its
# transposed store's 32-byte column segments; 62 chunks fit beside them);
# one persistent block an SM of up to 512 threads
MXU_ROWS_SMEM = (MAX_BLOCK_SMEM - 60 * DFT_RES_CHUNK_BYTES["default"] - DFT_RES_BAR - 1024)
MXU_THREADS = 512
# groups a persistent block should hold at least: one warp task of 8 for
# each of its 16 warps
MXU_TASK_GROUPS = 64


def t_stage_groups(stages: int) -> tuple:
    """The S radix-2 stages cut into ceil(S / 4) groups of consecutive
    stages, as even as possible (11 -> 4 + 4 + 3): ((s_lo, k), ...) in
    DIF order, top stages first; group (s_lo, k) runs stages s_lo ..
    s_lo + k - 1."""
    n_groups = -(-stages // T_MAX_K)
    base, extra = divmod(stages, n_groups)
    groups, hi = [], stages
    for g in range(n_groups):
        k = base + (g < extra)
        groups.append((hi - k, k))
        hi -= k
    return tuple(groups)


def t_pad(i):
    """Padded shared-memory column: one word in every 32 left empty."""
    return i + (i >> 5)


def t_row_stride(n: int, rows: int) -> int:
    """Padded row stride (floats) with stride % 32 == 32 / min(rows, 32)
    (mod 32): the transposed read, neighbouring threads on neighbouring
    rows of one column, then hits distinct banks."""
    stride, want = t_pad(n), (32 // min(rows, 32)) % 32
    while stride % 32 != want:
        stride += 1
    return stride


class TPlan(NamedTuple):
    """One launch's block geometry and stage groups (B1's t_plan, B3/B6's
    r_plan, B2/B7's s_plan): rows = 2^lr rows of n = R * 2^logq points a
    block, padded row stride rs (floats), `threads` threads, per group
    (s_lo, k, ub_shift, row_shift), and whether B1's last group of two or
    more stores its registers straight to the transposed output
    (direct_store) or through shared memory (s_plan: whether the top DIF
    group loads, and B2's top DIT group stores, device memory).
    dit_groups: B2's and B10's maps of their DIT groups (s_plan), ()
    elsewhere."""

    n: int
    logq: int
    lr: int
    rs: int
    threads: int
    groups: tuple
    direct_store: bool = False
    dit_groups: tuple = ()

    @property
    def rows(self) -> int:
        return 1 << self.lr

    @property
    def slot_sets(self) -> int:
        return self.rows * self.n // T_SLOTS

    @property
    def smem_bytes(self) -> int:
        return 8 * self.rows * self.rs

    def c_plan(self, dit: bool = False) -> np.ndarray:
        """The int32 plan array of the C entry (dit: of B2's DIT maps)."""
        groups = self.dit_groups if dit else self.groups
        return np.array([len(groups), int(self.direct_store)]
                        + [v for g in groups for v in g], np.int32)


def t_slot_index(plan: TPlan, group: tuple, brev: bool = False) -> tuple:
    """(row, column) in the block of every (slot set, slot) of a stage
    group (s_lo, k, ub_shift, row_shift): two (slot_sets, 16) int arrays.
    Slot j of slot set u holds element j mod 2^k of item u + (j >> k) *
    slot_sets; an item's bit fields are (q-block field ub, row, cross
    block c), ub the column bits outside the group's stages: column =
    c * q + lo | hb << (s_lo + k) | jl << s_lo. brev: the natural
    ordering's first DIT group (csrc/fft_groups.cuh LD_BREV), whose ub is
    the bit reverse of the map's field; its slot at column b was loaded
    from device column bit_reverse(b) (`brev_columns`)."""
    s_lo, k, ub_shift, row_shift = group
    lq = plan.logq - k
    ns = plan.slot_sets
    u = np.arange(ns, dtype=np.int64)[:, None]
    j = np.arange(T_SLOTS, dtype=np.int64)[None, :]
    it = u + (j >> k) * ns
    ub = (it >> ub_shift) & ((1 << lq) - 1)
    if brev:
        ub = brev_columns(ub, lq)
    row = (it >> row_shift) & (plan.rows - 1)
    c = it >> (lq + plan.lr)
    col = ((c << plan.logq) | (ub & ((1 << s_lo) - 1)) | ((ub >> s_lo) << (s_lo + k))
           | ((j & ((1 << k) - 1)) << s_lo))
    return row, col


def brev_columns(x, bits: int):
    """The bit reverse of each entry of x over its low `bits` bits."""
    x = np.asarray(x, dtype=np.int64)
    out = np.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def t_cross_columns(plan: TPlan, radices: tuple) -> np.ndarray:
    """The cross pass's element map: item b < q of a row holds columns b +
    j * q, j = j0 * R1 + j1 < R (element b + j1*q + j0*q0): a (q, R)
    array."""
    r = math.prod(radices)
    q = 1 << plan.logq
    return np.arange(q)[:, None] + np.arange(r)[None, :] * q


def t_bank_conflicts(plan: TPlan, group: tuple, brev: bool = False) -> int:
    """The most threads of one warp that hit one bank with one shared
    access of a stage group (1: conflict-free); warps are 32 consecutive
    slot sets."""
    row, col = t_slot_index(plan, group, brev)
    addr = row * plan.rs + t_pad(col)
    warp = np.arange(addr.shape[0])[:, None] // 32
    key = (warp * T_SLOTS + np.arange(T_SLOTS)[None, :]) * 32 + addr % 32
    return int(np.bincount(key.ravel()).max())


def _t_store_conflicts(plan: TPlan) -> int:
    """Bank conflicts of the shared-memory transposed read (and of the
    inverse cross pass's store): neighbouring threads on neighbouring rows
    of one column."""
    t = np.arange(min(32, plan.rows * plan.n))
    addr = (t & (plan.rows - 1)) * plan.rs + t_pad(t >> plan.lr)
    return int(np.bincount(addr % 32).max())


@functools.lru_cache(maxsize=None)
def t_plan(n: int, radices: tuple = (), m: int = 1 << 30, inverse: bool = False,
           blocks_wanted: int = 0, mxu: bool = False, resident: bool = True) -> TPlan:
    """The fft_rows_t plan of a length-n row pass over planes of m rows.

    Rows a block: the largest power of two up to the plane height (and
    T_MAX_ROWS) whose padded rows fit T_SMEM_BUDGET, at least 16 / q so
    every thread's 16 slots are full; halved while the launch (m rows a
    pair, blocks_wanted / plane count) would have fewer than blocks_wanted
    blocks, down to T_MIN_ROWS_STORE (a small launch of large blocks
    leaves SMs idle). The forward pass with 4 rows or more and two groups
    or more stores the last group's registers straight to the transposed
    output (its map row first: neighbouring threads on neighbouring rows);
    other passes read the output columns from shared memory. Per stage group the
    thread-to-item map puts neighbouring threads along the row (ub first:
    coalesced, and conflict-free where the group's low bits span a warp)
    or across rows (row first), whichever t_bank_conflicts finds cheaper;
    the forward pow2 pass's first group reads device memory and keeps the
    row map. The row stride is the first past the padded row that keeps
    the shared-memory transposed read conflict-free and the groups'
    accesses cheapest. mxu: the groups cover the outer stages 7 .. S - 1
    (stage_spec; the group DFT runs the rest), every pass stores through
    shared memory and the rows are those that fit MXU_ROWS_SMEM beside the
    resident tables (8 at n = 2048, 32 at 256), whatever blocks_wanted
    asks: the kernel's persistent blocks walk over the row blocks;
    resident=False (the forward passes at 'default', resident_route):
    the L2 design's plan, its rows as roll's."""
    radices = tuple(radices)
    stages = check_length(n, radices)
    check_kernel_length(n)
    q = 1 << stages
    rows = max(1, T_SLOTS // q)
    cap = max(rows, min(T_MAX_ROWS, 1 << max(0, m - 1).bit_length()))
    res = mxu and resident
    budget = MXU_ROWS_SMEM if res else T_SMEM_BUDGET
    while rows * 2 <= cap and 16 * rows * (t_pad(n) + 32) <= budget:
        rows *= 2
    floor = max(T_MIN_ROWS_STORE, T_SLOTS // q)
    while not res and rows > floor and -(-m // rows) < blocks_wanted:
        rows //= 2
    lr = rows.bit_length() - 1
    ns = rows * n // T_SLOTS
    threads = min(T_THREADS, -(-ns // 32) * 32)
    spec = stage_spec(stages, mxu)
    direct = not inverse and not mxu and rows >= 4 and len(spec) > 1
    best = None
    for extra in range(32):
        plan = TPlan(n, stages, lr, t_pad(n) + extra, threads, (), direct)
        if not direct and _t_store_conflicts(plan) > 1:
            continue
        groups, costs = [], []
        for g, (s_lo, k) in enumerate(spec):
            along, across = (s_lo, k, 0, stages - k), (s_lo, k, lr, 0)
            if direct and g == len(spec) - 1:
                choice = [across]
            elif (g == 0 and not inverse and not radices) or lr == 0:
                choice = [along]
            else:
                choice = [along, across]
            cost = [t_bank_conflicts(plan, c) for c in choice]
            groups.append(choice[int(np.argmin(cost))])
            costs.append(min(cost))
        key = (max(costs, default=1), sum(costs))
        if best is None or key < best[0]:
            best = key, plan._replace(groups=tuple(groups))
        if key == (1, len(spec)):
            break
    plan = best[1]
    if plan.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError(f"a row of {n} points does not fit a block's shared memory")
    return plan


# ---------------------------------------------------------------------------
# B3/B6's plan (csrc/fft_rows.cu): the same stage groups, the row-major
# stores. The CPU tests run it group by group against run_stages too.

R_THREADS = 256  # the kernel's __launch_bounds__(256, 2): 128 registers a thread
# the plan's geometry, measured on an H100 (tools/rows_geometry.py): 128
# threads a block; natural-store blocks of rows in 32 KB of shared memory
# (2 rows at n = 2048, 1 at 2304-4096), packed-store blocks of one min/max
# partial's rows (rows_per_block: 4 at 2048)
R_PLAN_THREADS = 128
R_SMEM_BUDGET = 32 << 10


def r_pinned(groups: int, g: int, mixed: bool, mxu: bool = False) -> bool:
    """Whether group g of a fft_rows plan of `groups` groups reads or
    writes device memory (and so keeps the along map: neighbouring
    threads on neighbouring columns): the bottom group always (the
    forward vector store, the inverse vector load, the natural ordering's
    bit-reversed load); the top group of a pow2 pass (the forward row
    load, the inverse and natural row store; a mixed pass's cross levels
    take those). mxu: the top group of a pow2 pass only (the group DFT
    takes the bottom stages)."""
    return (g == groups - 1 and not mxu) or (g == 0 and not mixed)


@functools.lru_cache(maxsize=None)
def r_plan(n: int, radices: tuple = (), m: int = 1 << 30, inverse: bool = False,
           natural: bool = False, rows: int = 0, threads: int = 0,
           packed: bool = False, mxu: bool = False, resident: bool = True) -> TPlan:
    """The fft_rows plan (B3, B6) of a length-n row pass over planes of m
    rows.

    Rows a block: the largest power of two up to 16 and the plane height
    whose rows fit R_SMEM_BUDGET (the natural store), or those of one
    min/max partial, rows_per_block(n, m) (the packed store: 4 at n =
    2048, 2 at 3840 and 4096); raised to 16 / q where a block of them
    would leave a thread's 16 slots unfilled. Threads: R_PLAN_THREADS (up
    to R_THREADS), fewer for a block of fewer slot sets, each thread
    looping over the slot sets. `rows` and `threads` override the two (a
    power of two and a multiple of 32: tools/rows_geometry.py). The top
    and bottom groups keep the along map where they touch device memory
    (r_pinned); a middle group takes the map, along or across, that
    t_bank_conflicts finds cheaper. The row stride is the first past the
    padded row that keeps the groups' accesses cheapest (the bit-reversed
    load's shared stores counted as the kernel makes them). mxu (revorder
    only): the groups cover the outer stages 7 .. S - 1 (stage_spec); one
    block of up to MXU_THREADS an SM beside the resident tables: a
    natural-store block takes the rows that fit MXU_ROWS_SMEM (8 at n =
    2048: 4 beside all of the tables took an H100 10% longer), a
    packed-store block those of one min/max partial as at roll
    (4 at n = 2048) or, where those hold fewer than MXU_TASK_GROUPS
    groups, that many groups' rows (32 at n = 256: two partials a
    block); resident=False (the forward passes at 'default',
    resident_route): the L2 design's plan, its rows and threads as
    roll's."""
    radices = tuple(radices)
    stages = check_length(n, radices)
    check_kernel_length(n)
    if natural:
        check_ordering("natural", radices)
        if mxu:
            raise ValueError("the mxu engine takes revorder passes")
    q = 1 << stages
    res = mxu and resident
    if not rows:
        if packed:
            fit = rows_per_block(n, m)
            if res:  # 64 groups a block or more (several min/max partials a block)
                fit = max(fit, min(MXU_TASK_GROUPS * MXU_INNER // n,
                                   MXU_ROWS_SMEM // (8 * (t_pad(n) + 32)), m))
        elif res:
            fit = max(1, min(T_MAX_ROWS, MXU_ROWS_SMEM // (8 * (t_pad(n) + 32)), m))
        else:
            fit = max(1, min(16, R_SMEM_BUDGET // (8 * n), m))
        rows = max(1 << (fit.bit_length() - 1), T_SLOTS // q)
    if rows & (rows - 1) or rows * q < T_SLOTS:
        raise ValueError(f"rows a block must be a power of two >= {T_SLOTS // q}, got {rows}")
    lr = rows.bit_length() - 1
    ns = rows * n // T_SLOTS
    most = MXU_THREADS if res else R_THREADS
    threads = threads or min(MXU_THREADS if res else R_PLAN_THREADS, -(-ns // 32) * 32)
    if threads % 32 or not 32 <= threads <= most:
        raise ValueError(f"threads a block must be a multiple of 32 up to {most}")
    spec = stage_spec(stages, mxu)
    best = None
    for extra in range(32):
        plan = TPlan(n, stages, lr, t_pad(n) + extra, threads, tuple(
            (s_lo, k, 0, stages - k) for s_lo, k in spec))
        groups, costs = [], []
        for g, (s_lo, k) in enumerate(spec):
            along, across = (s_lo, k, 0, stages - k), (s_lo, k, lr, 0)
            pinned = r_pinned(len(spec), g, bool(radices), mxu)
            choice = [along] if pinned or lr == 0 else [along, across]
            brev = natural and g == len(spec) - 1
            cost = [t_bank_conflicts(plan, c, brev) for c in choice]
            groups.append(choice[int(np.argmin(cost))])
            costs.append(min(cost))
        key = (max(costs, default=1), sum(costs))
        if best is None or key < best[0]:
            best = key, plan._replace(groups=tuple(groups))
        if key == (1, len(spec)):
            break
    plan = best[1]
    if plan.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError(f"a row of {n} points does not fit a block's shared memory")
    return plan


# ---------------------------------------------------------------------------
# B2/B7/B10's plan (csrc/wiener_spectral.cu): the spectral middles on the
# same stage groups. The DIF groups run top down, the bottom group runs its
# DIF stages, the filter and (B2, B10) its DIT stages in one register pass,
# B2's and B10's DIT groups run bottom up. The CPU tests emulate it group
# by group.

S_STORES = ("transposed", "natural", "rows")  # B2's store, B7's, B10's
# the MXU instances' shared rows: a block's shared memory less the table
# and the mbarrier (the spectral kernels have no static shared memory); a
# row's stride slack when the plan counts the rows that fit
S_MXU_ROWS_SMEM = MAX_BLOCK_SMEM - DFT_HALF_BYTES - DFT_RES_BAR
S_MXU_SLACK = 8


def spectral_resident(store: str, code: int) -> bool:
    """Whether a B2 or B7 launch at an engine code keeps the group DFT's
    table resident in shared memory (csrc/wiener_spectral.cu
    spectral_s_mxu_kernel: persistent blocks, s_plan's resident rows):
    every tensor-core one but B7's at 'default', which keeps the L2 design
    (spectral_s_l2_kernel: its fragment tables read through L1 and L2),
    faster there on an H100."""
    return bool(code) and not (store == "natural" and code == 1)


def spectral_table_pointer(store: str, code: int, device) -> int:
    """The group DFT's table pointer of a B2/B7 launch (0 at roll): the
    half table of both directions where resident (dft_half_tables), else
    the L2 design's forward fragment tables (dft_fragments)."""
    if not code:
        return 0
    precision = MXU_PRECISIONS[code - 1]
    if spectral_resident(store, code):
        return dft_half_tables(precision, device).data_ptr()
    return dft_fragments(False, precision, device).data_ptr()


def s_pinned(groups: int, g: int, k: int, direct: bool, mxu: bool = False) -> bool:
    """Whether group g (k stages) of an s_plan of `groups` groups keeps the
    along map in its DIF pass: the top group when it loads device memory
    (direct; B10's top DIT group stores the row-major output through the
    same map), and a bottom group of items narrower than a 32-byte segment
    (k < 3), whose vectors of H (and B7's stores) need their neighbours'
    to fill one; mxu: no bottom group, the group DFT reads H)."""
    return (g == 0 and direct) or (g == groups - 1 and k < 3 and not mxu)


@functools.lru_cache(maxsize=None)
def s_plan(n: int, radices: tuple = (), m: int = 1 << 30, store: str = "transposed",
           blocks_wanted: int = 0, rows: int = 0, threads: int = 0, mxu: bool = False,
           resident: bool = True) -> TPlan:
    """The plan of a spectral middle over planes of m rows of length n:
    B2 (store="transposed", wiener_spectral_t and spectral_conv_t), B7
    (store="natural", fwd_wiener_rows) or B10 (store="rows",
    wiener_spectral_rows: pow2 rows only).

    Rows a block: B2 as t_plan (the largest power of two up to the next
    one >= m, T_MAX_ROWS and the T_SMEM_BUDGET of padded rows; halved while
    the launch has fewer than blocks_wanted blocks, down to
    T_MIN_ROWS_STORE, whose 32-byte column segments the transposed store
    then writes: 8 rows at n = 2048 and 2304, 4 at 3840 and 4096); B7 and
    B10 as r_plan's natural store (the rows in R_SMEM_BUDGET, up to 16: 2
    at n = 2048); at least 16 / q either way, so every thread's 16 slots
    are full. A ragged last block reads zero rows. Threads: T_THREADS (B2)
    or R_PLAN_THREADS (B7, B10), fewer for a block of fewer slot sets.
    `rows` and `threads` override the two (tools/rows_geometry.py; rows
    below 16 / q take 16 / q).

    direct_store: a pow2 row of two groups or more; its top DIF group
    loads device memory (the along map) and the top DIT group stores the
    output from registers: B2's transposed one through the across map
    (neighbouring threads on neighbouring rows of one output column),
    B10's row-major one through the along map of its top DIF group. A
    smooth row or a single group goes through the shared rows (the cross
    levels of a smooth row in registers as it loads and stores). The groups
    s_pinned names keep the along map; another takes the map, along or
    across, that t_bank_conflicts finds cheaper, in the DIT pass as in the
    DIF pass. The row stride is the first past the padded row that keeps
    the groups' accesses cheapest (and, without direct_store, B2's
    transposed read of the shared rows conflict-free).

    mxu (B2, B7): the groups cover the outer stages 7 .. S - 1
    (stage_spec), the group DFTs and the filter between them; direct_store
    at a pow2 row with one outer group or more. The rows are those of one
    persistent block an SM beside the resident table
    (csrc/wiener_spectral.cu spectral_s_mxu_kernel), B7's as B2's: the
    most (up to T_MAX_ROWS and the plane height, whatever blocks_wanted
    asks) whose padded rows with S_MXU_SLACK words of stride slack fit
    S_MXU_ROWS_SMEM (8 at n = 2048 and 2304, 4 at 3840 and 4096, 64 at
    256), the stride within it; T_THREADS threads. resident=False (B7 at
    'default', spectral_resident): the L2 design's plan, the rows and threads as
    roll's."""
    radices = tuple(radices)
    stages = check_length(n, radices)
    check_kernel_length(n)
    if store not in S_STORES:
        raise ValueError(f"unknown store {store!r}; one of {S_STORES}")
    if store == "rows" and radices:
        raise ValueError("B10's row store takes power-of-two rows only")
    if store == "rows" and mxu:
        raise ValueError("B10 runs the radix-2 stages only")
    transposed = store == "transposed"
    q = 1 << stages
    floor = T_SLOTS // q if q < T_SLOTS else 1
    res = mxu and resident
    if rows:
        rows = max(rows, floor)
    elif res:
        cap = max(floor, min(T_MAX_ROWS, 1 << max(0, m - 1).bit_length()))
        rows = 1
        while rows * 2 <= cap and 16 * rows * (t_pad(n) + S_MXU_SLACK) <= S_MXU_ROWS_SMEM:
            rows *= 2
        rows = max(rows, floor)
    else:
        cap = max(floor, min(T_MAX_ROWS if transposed else 16, 1 << max(0, m - 1).bit_length()))
        # bytes of one row: B2's padded row and its stride's slack, B7's and
        # B10's row (as r_plan counts them)
        row_bytes, budget = ((8 * (t_pad(n) + 32), T_SMEM_BUDGET) if transposed
                             else (8 * n, R_SMEM_BUDGET))
        rows = 1
        while rows * 2 <= cap and 2 * rows * row_bytes <= budget:
            rows *= 2
        rows = max(rows, floor)
        if transposed:
            while rows > max(T_MIN_ROWS_STORE, floor) and -(-m // rows) < blocks_wanted:
                rows //= 2
    if rows & (rows - 1) or rows < floor:
        raise ValueError(f"rows a block must be a power of two >= {floor}, got {rows}")
    lr = rows.bit_length() - 1
    ns = rows * n // T_SLOTS
    threads = threads or min(T_THREADS if transposed or res else R_PLAN_THREADS, -(-ns // 32) * 32)
    if threads % 32 or not 32 <= threads <= T_THREADS:
        raise ValueError(f"threads a block must be a multiple of 32 up to {T_THREADS}")
    spec = stage_spec(stages, mxu)
    direct = not radices and len(spec) > (0 if mxu else 1)
    best = None
    for extra in range(32):
        plan = TPlan(n, stages, lr, t_pad(n) + extra, threads, (), direct)
        if res and plan.smem_bytes > S_MXU_ROWS_SMEM:
            break
        if transposed and not direct and _t_store_conflicts(plan) > 1:
            continue
        dif, dit, costs = [], [], []
        for g, (s_lo, k) in enumerate(spec):
            along, across = (s_lo, k, 0, stages - k), (s_lo, k, lr, 0)
            pinned = s_pinned(len(spec), g, k, direct, mxu)
            choice = [along] if pinned or lr == 0 else [along, across]
            cost = [t_bank_conflicts(plan, c) for c in choice]
            dif.append(choice[int(np.argmin(cost))])
            costs.append(min(cost))
            if transposed and g == 0 and direct:  # the top DIT group's direct store
                dit.append(across)
                costs.append(t_bank_conflicts(plan, across))
            elif store != "natural":  # B2's other DIT groups, all of B10's
                dit.append(dif[-1])
        key = (max(costs, default=1), sum(costs))
        if best is None or key < best[0]:
            best = key, plan._replace(groups=tuple(dif), dit_groups=tuple(dit))
        if key == (1, len(costs)):
            break
    if best is None or best[1].smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError(f"a row of {n} points does not fit a block's shared memory")
    return best[1]


# ---------------------------------------------------------------------------
# plain versions: the JAX stage bodies (_dif_stage/_dit_stage) on tensors


def _dif_stage(x_re, x_im, wc, ws, m, half):
    p_re, p_im = torch.roll(x_re, -half, -1), torch.roll(x_im, -half, -1)
    q_re, q_im = torch.roll(x_re, half, -1), torch.roll(x_im, half, -1)
    d_re = q_re - x_re
    d_im = q_im - x_im
    first = m > 0.5
    return (
        torch.where(first, x_re + p_re, wc * d_re - ws * d_im),
        torch.where(first, x_im + p_im, wc * d_im + ws * d_re),
    )


def _dit_stage(x_re, x_im, wc, ws, m, half):
    p_re, p_im = torch.roll(x_re, -half, -1), torch.roll(x_im, -half, -1)
    q_re, q_im = torch.roll(x_re, half, -1), torch.roll(x_im, half, -1)
    first = m > 0.5
    return (
        torch.where(first, x_re + (wc * p_re - ws * p_im), q_re - (wc * x_re - ws * x_im)),
        torch.where(first, x_im + (wc * p_im + ws * p_re), q_im - (wc * x_im + ws * x_re)),
    )


def _cross_dft_level(x_re, x_im, r, w, inverse):
    """r-point DFT across the q-wide sub-blocks (q = w / r) of every
    w-wide block of the last axis:
        out[.., base + k1*q + j2] = sum_j1 x[.., base + j1*q + j2] * W_r^{sign*k1*j1},
    in the JAX package's order (j1 ascending, an exact-1 coefficient
    skipped)."""
    shape = x_re.shape
    q = w // r
    blocks = shape[:-1] + (shape[-1] // w, r, q)
    x_re, x_im = x_re.reshape(blocks), x_im.reshape(blocks)
    c, s = _cross_coefs_np(r, inverse)
    outs_re, outs_im = [], []
    for k1 in range(r):
        acc_re = acc_im = None
        for j1 in range(r):
            sr, si = x_re[..., j1, :], x_im[..., j1, :]
            m = (k1 * j1) % r
            if m == 0:  # coefficient is exactly 1
                t_re, t_im = sr, si
            else:
                cm, sm = float(c[m]), float(s[m])
                t_re = cm * sr - sm * si
                t_im = cm * si + sm * sr
            acc_re = t_re if acc_re is None else acc_re + t_re
            acc_im = t_im if acc_im is None else acc_im + t_im
        outs_re.append(acc_re)
        outs_im.append(acc_im)
    return torch.stack(outs_re, -2).reshape(shape), torch.stack(outs_im, -2).reshape(shape)


def _twiddle(x_re, x_im, tc, ts):
    return x_re * tc - x_im * ts, x_re * ts + x_im * tc


def _mixed_cross_fwd(x_re, x_im, radices, xc, xs):
    """Forward mixed-radix prefix: per level, outermost first, the cross
    r-DFT then the level's twiddle plane. Each q-wide block is then an
    independent q-point problem for the DIF stages; the spectrum comes out
    in residue-block order, bit-reversed inside each block (cancelled by
    the symmetric inverse, like revorder's bit reversal)."""
    w = x_re.shape[-1]
    for lvl, r in enumerate(radices):
        x_re, x_im = _cross_dft_level(x_re, x_im, r, w, inverse=False)
        x_re, x_im = _twiddle(x_re, x_im, xc[lvl], xs[lvl])
        w //= r
    return x_re, x_im


def _mixed_cross_inv(x_re, x_im, radices, xc, xs):
    """Inverse mixed-radix suffix: levels innermost first, each the
    (conjugate) twiddle plane then the conj-coefficient cross r-DFT.
    Unscaled: fwd then inv gains r per level (times q) = n."""
    widths = [x_re.shape[-1]]
    for r in radices[:-1]:
        widths.append(widths[-1] // r)
    for lvl in range(len(radices) - 1, -1, -1):
        x_re, x_im = _twiddle(x_re, x_im, xc[lvl], xs[lvl])
        x_re, x_im = _cross_dft_level(x_re, x_im, radices[lvl], widths[lvl], inverse=True)
    return x_re, x_im


ORDERINGS = ("revorder", "natural")


def check_ordering(ordering: str, radices: tuple = ()) -> bool:
    """True for 'natural', False for 'revorder'; natural ordering takes a
    pow2 length only (the JAX fft_rows_pallas refuses radices with it)."""
    if ordering not in ORDERINGS:
        raise ValueError(f"unknown ordering {ordering!r}; one of {ORDERINGS}")
    if ordering == "natural" and radices:
        raise ValueError("mixed-radix (radices) requires revorder ordering")
    return ordering == "natural"


def bit_reverse_last_axis(x: torch.Tensor) -> torch.Tensor:
    """Bit-reversal permutation of a pow2 last axis, as a reshape to
    log2(n) axes of 2 and a permute reversing them (the JAX
    ops/fft.py:_bit_reverse_last_axis)."""
    n = x.shape[-1]
    m = n.bit_length() - 1
    lead = tuple(x.shape[:-1])
    y = x.reshape(lead + (2,) * m)
    axes = tuple(range(len(lead))) + tuple(len(lead) + m - 1 - i for i in range(m))
    return y.permute(axes).reshape(lead + (n,))


def run_stages(x_re, x_im, inverse: bool, radices: tuple = (), natural: bool = False,
               engine: str = "roll", precision: str = "default"):
    """The transform over the last axis: forward = the cross levels (for
    radices) then the DIF stages over the pow2 tail; inverse = the DIT
    stages then the inverse cross levels (the JAX _run_stages), with the
    tables of the tensors' device. natural: natural order in and out —
    bit-reverse the input, then the DIT stages with this direction's
    tables (the JAX 'natural' ordering; pow2 only). engine: where it
    resolves to mxu (resolve_engine), the DIF stages stop at stage 7 and
    `group_dft_plain` at `precision` runs the inner 7 (forward last,
    inverse first: the JAX _fft_stages_mxu)."""
    n = x_re.shape[-1]
    radices = tuple(radices)
    stages = check_length(n, radices)
    t = tables(n, bool(inverse), x_re.device, radices)
    mxu = pass_engine(engine, n, radices, "natural" if natural else "revorder") == "mxu"
    check_precision(precision)
    if natural:
        check_ordering("natural", radices)
        x_re, x_im = bit_reverse_last_axis(x_re), bit_reverse_last_axis(x_im)
    if radices and not inverse:
        x_re, x_im = _mixed_cross_fwd(x_re, x_im, radices, t.xcos, t.xsin)
    dit = inverse or natural
    low = MXU_LOG if mxu else 0
    order = range(low, stages) if dit else range(stages - 1, low - 1, -1)
    stage = _dit_stage if dit else _dif_stage
    if mxu and inverse:
        x_re, x_im = group_dft_plain(x_re, x_im, True, precision)
    for s in order:
        x_re, x_im = stage(x_re, x_im, t.cos[s], t.sin[s], t.mask[s], 1 << s)
    if mxu and not inverse:
        x_re, x_im = group_dft_plain(x_re, x_im, False, precision)
    if radices and inverse:
        x_re, x_im = _mixed_cross_inv(x_re, x_im, radices, t.xcos, t.xsin)
    return x_re, x_im


def _logical(x, planes, extent):
    """(p, m, n) u8/f32/bf16 planes -> (planes, M, N) float32, zero beyond."""
    big_m, big_n = extent
    out = torch.zeros((planes, big_m, big_n), dtype=torch.float32, device=x.device)
    p, m, n = x.shape
    p, m, n = min(p, planes), min(m, big_m), min(n, big_n)
    v = x[:p, :m, :n]
    out[:p, :m, :n] = u8_to_unit(v) if v.dtype == torch.uint8 else v
    return out


# the planes' element type as the C entries take it (csrc/fft_rows.cu IN_*)
IN_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.bfloat16: 2}
# the storage dtype of bf16 staging's planes (out_dtype)
STAGE_DTYPE = torch.bfloat16


def check_out_dtype(out_dtype, transposed=True, inverse=False):
    """None (float32) or torch.bfloat16: the storage dtype of B1's
    forward transposed store. As in JAX, bf16 staging stores only through
    the transposed store; the port stores it on forward passes only (the
    pipelines' one use)."""
    if out_dtype is None or out_dtype == torch.float32:
        return None
    if out_dtype != STAGE_DTYPE:
        raise ValueError(f"out_dtype must be None, float32 or bfloat16, got {out_dtype}")
    if not transposed:
        raise ValueError("out_dtype (bf16 staging) is only supported with the transposed "
                         "store (transposed=True)")
    if inverse:
        raise ValueError("out_dtype (bf16 staging) stores forward passes only")
    return STAGE_DTYPE


def _stage_out(x_re, x_im, out_dtype):
    """The plain versions' store: float32 as it is, or rounded to out_dtype."""
    if out_dtype is None:
        return x_re, x_im
    return x_re.to(out_dtype), x_im.to(out_dtype)


def _check_planes(re, im, extent, radices):
    if re.ndim != 3:
        raise ValueError(f"need (P, M, N) planes, got shape {tuple(re.shape)}")
    if re.dtype not in IN_DTYPES:
        raise ValueError(f"planes must be uint8, float32 or bfloat16, got {re.dtype}")
    if im is not None:
        if im.dtype != re.dtype or im.shape[1:] != re.shape[1:] or im.shape[0] > re.shape[0]:
            raise ValueError(
                f"im planes {tuple(im.shape)} {im.dtype} do not match re "
                f"{tuple(re.shape)} {re.dtype}"
            )
    big_m, big_n = extent if extent is not None else re.shape[1:]
    if big_m < 1:
        raise ValueError(f"plane height must be >= 1, got {big_m}")
    check_length(big_n, radices)
    return int(big_m), int(big_n)


def _check_store(ordering, radices, transposed, in_dtype=torch.float32) -> bool:
    natural = check_ordering(ordering, radices)
    if natural and transposed:
        raise ValueError("the transposed store takes revorder ordering (B1's order)")
    if in_dtype == STAGE_DTYPE and (natural or transposed):
        raise ValueError("bfloat16 planes (bf16 staging) load in revorder passes with the "
                         "natural store only (B6, as the pipelines read them)")
    return natural


def fft_rows_plain(re, im=None, *, inverse=False, transposed=False, extent=None, radices=(),
                   ordering="revorder", engine="roll", precision="default", out_dtype=None):
    """Plain version of `fft_rows` (same signature and layout)."""
    natural = _check_store(ordering, radices, transposed, re.dtype)
    out_dtype = check_out_dtype(out_dtype, transposed, inverse)
    big_m, big_n = _check_planes(re, im, extent, radices)
    planes = re.shape[0]
    x_re = _logical(re, planes, (big_m, big_n))
    x_im = (
        torch.zeros_like(x_re) if im is None else _logical(im, planes, (big_m, big_n))
    )
    x_re, x_im = run_stages(x_re, x_im, inverse, radices, natural, engine, precision)
    if transposed:
        x_re, x_im = x_re.transpose(1, 2).contiguous(), x_im.transpose(1, 2).contiguous()
    return _stage_out(x_re, x_im, out_dtype)


def fft_rows(re, im=None, *, inverse=False, transposed=False, extent=None, radices=(),
             ordering="revorder", engine="roll", precision="default", out_dtype=None):
    """Row FFT over the last axis of (P, m, n) planes (B1/B6).

    re, im: uint8 or float32 planes of any strides (im with re's strides);
    im=None is a real input, and im with fewer planes than re reads the
    missing ones as zero — so `frame.permute(2, 0, 1)[0::2]` /
    `[1::2]` of an (H, W, 3) frame is the channel-pair packing with no
    copy. uint8 converts as x / 255 in the load.
    extent=(M, N): the transform's plane size; rows >= m and columns >= n
    are zero (the pow2 pad), and only the live rows are transformed.
    Returns float32 (re, im) of shape (P, N, M) if transposed else
    (P, M, N). Forward = DIF (bit-reversed out), inverse = DIT
    (bit-reversed in), unscaled. radices: the odd cross-DFT radices of a
    smooth N = prod(radices) * 2^k (module docstring), () for a pow2 N.
    ordering='natural' (pow2 N, natural store only): natural order in and
    out, the DIT stages running with this direction's tables on the
    bit-reversed row, which the first stage group loads straight from
    the natural input (B6's natural mode, the `pallas` backend of
    ops/fft.py; counted under "fft_rows_natural" too).
    transposed=True launches B1's kernel (csrc/fft_rows_t.cu, counted
    under "fft_rows_t" too); the natural store launches csrc/fft_rows.cu
    (B6). Both run the stages in register groups and write the rows past
    the live ones as zeros themselves.
    engine / precision: the JAX package's engine= ('roll', 'mxu', 'auto';
    module docstring) and the mxu group product's precision; a pass
    that resolves to mxu launches the tensor-core instance (counted under
    "fft_rows_t_mxu_<precision>" or "fft_rows_mxu_<precision>" too).
    bf16 staging (module docstring): out_dtype=torch.bfloat16 stores a
    forward transposed pass as bfloat16 ("fft_rows_t_bf16"); bfloat16
    planes load in a revorder pass with the natural store ("fft_rows_bf16").
    """
    if not on_cuda(*(t for t in (re, im) if t is not None)):
        return fft_rows_plain(re, im, inverse=inverse, transposed=transposed, extent=extent,
                              radices=radices, ordering=ordering, engine=engine,
                              precision=precision, out_dtype=out_dtype)
    natural = _check_store(ordering, radices, transposed, re.dtype)
    out_dtype = check_out_dtype(out_dtype, transposed, inverse)
    big_m, big_n = _check_planes(re, im, extent, radices)
    code = engine_code(engine, big_n, radices, ordering, precision)
    planes, m, n = re.shape
    shape = (planes, big_n, big_m) if transposed else (planes, big_m, big_n)
    # both kernels write the rows past the live ones (zeros) themselves
    out_re = torch.empty(shape, dtype=out_dtype or torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    ps, rs, cs = re.stride()
    if im is not None and (
        im.stride()[1:] != (rs, cs) or (im.shape[0] > 1 and im.stride(0) != ps)
    ):
        raise ValueError("the kernel reads re and im planes with one set of strides")
    args = (re, im, PlaneMap(ps, 0, 1, 1, 0, rs, cs), planes,
            0 if im is None else im.shape[0], min(m, big_m), min(n, big_n), big_m, big_n)
    if transposed:
        _launch_t(*args, out_re, out_im, inverse, radices, code)
    else:
        _launch(*args, out_re.data_ptr(), out_im.data_ptr(), big_m * big_n, None, inverse,
                radices, natural, code)
    return out_re, out_im


def _check_stack(stack, extent, radices):
    if stack.ndim != 4:
        raise ValueError(f"need a (B, h, w, C) stack, got shape {tuple(stack.shape)}")
    if stack.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"stack must be uint8 or float32, got {stack.dtype}")
    b, h, w, c = stack.shape
    big_m, big_n = extent
    if not (1 <= h <= big_m and 1 <= w <= big_n) or b < 1 or c < 1:
        raise ValueError(f"stack {tuple(stack.shape)} does not fit the extent {extent}")
    check_length(big_n, radices)
    return int(big_m), int(big_n)


def stack_pairs_plain(stack):
    """(B, h, w, C) stack -> (re, im) channel-pair planes, the loader's
    (image, channel) map applied with index tensors: logical plane q is
    image q // C, channel q % C; re takes the even planes, im the odd ones
    (ceil(B*C/2) and floor(B*C/2) planes)."""
    b, _, _, c = stack.shape
    q = torch.arange(b * c, device=stack.device)
    planes = stack.permute(0, 3, 1, 2)[q // c, q % c]
    return planes[0::2], planes[1::2]


def fft_rows_stack_plain(stack, *, extent, radices=(), engine="roll", precision="default",
                         out_dtype=None):
    """Plain version of `fft_rows_stack` (same signature and layout)."""
    big_m, big_n = _check_stack(stack, extent, radices)
    re, im = stack_pairs_plain(stack)
    return fft_rows_plain(re, im, transposed=True, extent=(big_m, big_n), radices=radices,
                          engine=engine, precision=precision, out_dtype=out_dtype)


def fft_rows_stack(stack, *, extent, radices=(), engine="roll", precision="default",
                   out_dtype=None):
    """Forward row FFT of a (B, h, w, C) uint8/float32 image stack of any
    strides, channel pairs packed across images (B1, stack loader).

    Logical plane q of the channel-major list (B*C, h, w) is image q // C,
    channel q % C; pair p reads planes 2p (re) and 2p+1 (im), the last im
    plane reading as zero when B*C is odd. extent=(M, N) is the zero-padded
    transform size (rows >= h and columns >= w are zero; only live rows
    are transformed). Returns float32 (re, im) of shape (ceil(B*C/2), N,
    M), transposed, bit-reversed along N, as `fft_rows(...,
    transposed=True)` gives for the same planes (radices, engine,
    precision and out_dtype as there: a uint8 stack stores bfloat16 planes
    straight from its bytes).
    """
    if not on_cuda(stack):
        return fft_rows_stack_plain(stack, extent=extent, radices=radices, engine=engine,
                                    precision=precision, out_dtype=out_dtype)
    big_m, big_n = _check_stack(stack, extent, radices)
    out_dtype = check_out_dtype(out_dtype)
    code = engine_code(engine, big_n, radices, "revorder", precision)
    b, h, w, c = stack.shape
    n_planes = b * c
    pairs = -(-n_planes // 2)
    out_re = torch.empty((pairs, big_n, big_m), dtype=out_dtype or torch.float32,
                         device=stack.device)
    out_im = torch.empty_like(out_re)
    bs, rs, cs, chs = stack.stride()
    _launch_t(stack, stack, PlaneMap(bs, chs, c, 2, 1, rs, cs), pairs, n_planes // 2,
              h, w, big_m, big_n, out_re, out_im, False, radices, code)
    return out_re, out_im


def fft_rows_packed_out_plain(re, im, *, inverse=True, radices=(), engine="roll",
                              precision="default"):
    """Plain version of `fft_rows_packed_out`."""
    _check_contiguous_pair(re, im, radices)
    planes, big_m, big_n = re.shape
    rows = rows_per_block(big_n, big_m)
    x_re, x_im = run_stages(re.float(), im.float(), inverse, radices, False, engine, precision)
    out = torch.stack([x_re, x_im], dim=1).reshape(2 * planes, big_m, big_n)
    blk_re = x_re.reshape(planes, big_m // rows, rows * big_n)
    blk_im = x_im.reshape(planes, big_m // rows, rows * big_n)
    mm = torch.stack(
        [blk_re.amin(-1), blk_re.amax(-1), blk_im.amin(-1), blk_im.amax(-1)], dim=-1
    )
    return out, mm.reshape(-1, 4)


def _check_contiguous_pair(re, im, radices):
    if re.ndim != 3 or re.shape != im.shape:
        raise ValueError(f"need matching (P, M, N) planes, got {tuple(re.shape)}")
    if re.dtype not in (torch.float32, STAGE_DTYPE) or im.dtype != re.dtype:
        raise ValueError("planes must be float32, or both bfloat16 (bf16 staging)")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    check_length(re.shape[-1], radices)
    m = re.shape[-2]
    if m % rows_per_block(re.shape[-1], m):
        raise ValueError(f"plane height {m} must be a multiple of the row block")


def fft_rows_packed_out(re, im, *, inverse=True, radices=(), engine="roll", precision="default"):
    """Row FFT of contiguous float32 (P, M, N) planes that writes ONE
    (2P, M, N) output, re at plane 2p and im at plane 2p+1 (the channel
    unpack of a packed-pair restore), plus [min_re, max_re, min_im,
    max_im] partials, one per rows_per_block(N, M) rows, of shape
    (P * M / rows_per_block(N, M), 4), row-block-major within each plane
    (B3, csrc/fft_rows.cu: the last stage group stores both planes and
    folds the min/max from registers). radices, engine and precision as
    in `fft_rows` (an mxu pass counted under
    "fft_rows_packed_out_mxu_<precision>" too). bfloat16 planes (bf16
    staging, B2's output) widen as they load ("fft_rows_packed_out_bf16");
    the output and partials stay float32.
    """
    if not on_cuda(re, im):
        return fft_rows_packed_out_plain(re, im, inverse=inverse, radices=radices, engine=engine,
                                         precision=precision)
    _check_contiguous_pair(re, im, radices)
    code = engine_code(engine, re.shape[-1], radices, "revorder", precision)
    planes, big_m, big_n = re.shape
    rows = rows_per_block(big_n, big_m)
    out = torch.empty((2 * planes, big_m, big_n), dtype=torch.float32, device=re.device)
    mm = torch.empty((planes * (big_m // rows), 4), dtype=torch.float32, device=re.device)
    ps, rs, cs = re.stride()
    plane = big_m * big_n
    _launch(re, im, PlaneMap(ps, 0, 1, 1, 0, rs, cs), planes, planes, big_m, big_n,
            big_m, big_n, out.data_ptr(), out.data_ptr() + 4 * plane, 2 * plane, mm, inverse,
            radices, False, code)
    return out, mm


class PlaneMap(NamedTuple):
    """Where the loader finds element (m, c) of logical plane q:
    (q // channels) * image + (q % channels) * channel + m * row + c * col,
    pair p reading plane p * qstep as re and p * qstep + qim as im."""

    image: int
    channel: int
    channels: int
    qstep: int
    qim: int
    row: int
    col: int


@functools.lru_cache(maxsize=256)
def _r_launch_args(big_n, radices, big_m, inverse, natural, packed, device, code=0) -> tuple:
    """The arguments of one fft_rows launch that depend on its shape only
    (the plan, the table, cross-level and fragment pointers), worked out
    once per shape and engine code, as _t_launch_args. The plan array
    stays alive in the cache."""
    plan = r_plan(big_n, radices, big_m, inverse, natural, packed=packed, mxu=bool(code),
                  resident=resident_route(code, inverse))
    t = tables(big_n, inverse, device, radices)
    c_plan = plan.c_plan()
    lpg = rows_per_block(big_n, big_m).bit_length() - 1  # rows of a min/max partial
    return ((plan.logq, plan.lr, plan.rs, plan.threads), lpg,
            (int(inverse), int(natural), t.cos.data_ptr(), t.sin.data_ptr(), c_plan.ctypes.data,
             *cross_args(big_n, radices, inverse, device), code,
             dft_res_pointer(code, inverse, device), res_chunks(code, plan, inverse)), c_plan)


def _launch(re, im, pmap, re_live, im_live, live_rows, live_cols, big_m, big_n, out_re,
            out_im, out_pair, mm, inverse, radices, natural=False, code=0):
    """One fft_rows launch (B3, B6: the row-major stores) over re_live
    pairs (every re plane is live; the first im_live im planes are), with
    r_plan's stage groups: pair p's output planes at the device pointers
    out_re and out_im plus p * out_pair floats; mm: B3's min/max partials
    (a tensor) or None; natural: the natural-order instance; code: the
    engine (engine_code)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    radices = tuple(radices)
    geometry, lpg, consts, _ = _r_launch_args(big_n, radices, big_m, bool(inverse),
                                              bool(natural), mm is not None, re.device, code)
    err = _build.load().fft_rows_launch(
        re.data_ptr(), None if im is None else im.data_ptr(),
        IN_DTYPES[re.dtype], pmap.image, pmap.channel, pmap.channels,
        pmap.qstep, pmap.qim, pmap.row, pmap.col, re_live, im_live,
        live_rows, live_cols, re_live, big_m, *geometry, out_re, out_im, out_pair,
        None if mm is None else mm.data_ptr(), lpg, *consts,
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "fft_rows")
    launch_counts["fft_rows"] += 1
    if radices:
        launch_counts["mixed_radix"] += 1
    if natural:
        launch_counts["fft_rows_natural"] += 1
    if code:
        count_mxu("fft_rows" if mm is None else "fft_rows_packed_out", code)
    if re.dtype == STAGE_DTYPE:
        launch_counts["fft_rows_bf16" if mm is None else "fft_rows_packed_out_bf16"] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _t_launch_args(big_n, radices, big_m, inverse, device, pairs, code=0) -> tuple:
    """The arguments of one fft_rows_t launch that depend on its shape
    only (the plan, the table, cross-level and fragment pointers), worked
    out once per shape and engine code: a restore enqueues a handful of
    launches a frame and is near host-bound. The plan array stays alive
    in the cache."""
    plan = t_plan(big_n, radices, big_m, inverse, -(-_sm_count(device) * T_MIN_WAVES // pairs),
                  mxu=bool(code), resident=resident_route(code, inverse))
    t = tables(big_n, inverse, device, radices)
    c_plan = plan.c_plan()
    return ((plan.logq, plan.lr, plan.rs, plan.threads), int(inverse), t.cos.data_ptr(),
            t.sin.data_ptr(), c_plan.ctypes.data, *cross_args(big_n, radices, inverse, device),
            code, dft_res_pointer(code, inverse, device), res_chunks(code, plan, inverse),
            c_plan)


def count_mxu(name: str, code: int) -> None:
    """Count a tensor-core launch of kernel `name` under
    "<name>_mxu_<precision>"."""
    launch_counts[f"{name}_mxu_{MXU_PRECISIONS[code - 1]}"] += 1


def _launch_t(re, im, pmap, re_live, im_live, live_rows, live_cols, big_m, big_n, out_re,
              out_im, inverse, radices, code=0):
    """One fft_rows_t launch (B1, the transposed store) over re_live
    pairs, with t_plan's stage groups; code: the engine (engine_code)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    radices = tuple(radices)
    geometry, *consts, _ = _t_launch_args(big_n, radices, big_m, bool(inverse), re.device,
                                          re_live, code)
    err = _build.load().fft_rows_t_launch(
        re.data_ptr(), None if im is None else im.data_ptr(),
        int(re.dtype == torch.uint8), pmap.image, pmap.channel, pmap.channels,
        pmap.qstep, pmap.qim, pmap.row, pmap.col, re_live, im_live,
        live_rows, live_cols, re_live, big_m, *geometry,
        out_re.data_ptr(), out_im.data_ptr(), int(out_re.dtype == STAGE_DTYPE), *consts,
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "fft_rows_t")
    launch_counts["fft_rows"] += 1
    launch_counts["fft_rows_t"] += 1
    if radices:
        launch_counts["mixed_radix"] += 1
    if code:
        count_mxu("fft_rows_t", code)
    if out_re.dtype == STAGE_DTYPE:
        launch_counts["fft_rows_t_bf16"] += 1


# ---------------------------------------------------------------------------
# B11: the column FFT (csrc/fft_cols.cu) on column stage groups. The
# kernel mirrors the index math below; the CPU tests run it group by group
# against the plain version.

# shared memory of one fft_cols block (a strip of `cols` columns x H rows,
# two float planes): 8 columns at H = 2048, 4 at H = 4096; at most 32
# columns (128 B of each row)
COLS_SMEM_BUDGET = 128 << 10
MAX_STRIP_COLS = 32
# the kernel's __launch_bounds__(512, 1): 128 registers a thread. Measured
# on an H100 (tools/rows_geometry.py --cols): two slot sets a thread, up
# to 512 threads, beat one (1024 threads of 64 registers spilled) and four
C_THREADS = 512


def cols_per_block(h: int, w: int) -> int:
    """Columns an fft_cols block holds: the largest power of two <= 32 that
    fits COLS_SMEM_BUDGET and is not past the next power of two >= w, at
    least 16 / h (a thread's 16 slots need h * cols >= 16)."""
    c = max(1, min(MAX_STRIP_COLS, COLS_SMEM_BUDGET // (8 * h), 1 << max(0, (w - 1).bit_length())))
    return max(1 << (c.bit_length() - 1), T_SLOTS // h if h < T_SLOTS else 1)


class ColPlan(NamedTuple):
    """One fft_cols launch's geometry: a block takes a strip of 2^lc
    columns and all h = 2^logh rows, `threads` threads looping over its
    slot sets, the column stages cut into `groups` ((s_lo, k), DIF order,
    t_stage_groups). Item it of group (s_lo, k) is column it mod cols and
    row field ub = it >> lc (neighbouring threads on neighbouring columns
    of one row): the 2^k rows lo | jl << s_lo | hb << (s_lo + k), lo = ub
    mod 2^s_lo, hb = ub >> s_lo. The strip lives in shared memory as
    re[h][cols] then im[h][cols], row r at the swizzled row `col_row`."""

    h: int
    logh: int
    lc: int
    threads: int
    groups: tuple

    @property
    def cols(self) -> int:
        return 1 << self.lc

    @property
    def slot_sets(self) -> int:
        return self.h * self.cols // T_SLOTS

    @property
    def swizzle(self) -> int:
        """The mask of the row bits the swizzle flips: the rows one warp's
        32 threads span in a group (32 / cols), at most h."""
        return max(1, min(32 >> self.lc, self.h)) - 1

    @property
    def smem_bytes(self) -> int:
        """A one-group launch exchanges nothing: no shared memory."""
        return 8 * self.h * self.cols if len(self.groups) > 1 else 0

    def c_plan(self) -> np.ndarray:
        """The int32 plan array of the C entry: groups, then per group
        s_lo and k."""
        return np.array([len(self.groups)] + [v for g in self.groups for v in g], np.int32)


def col_row(plan: ColPlan, r):
    """The shared-memory row of strip row r: r with its low bits flipped by
    r >> k_bottom (the bottom group's width), so that the 32 / cols rows a
    warp spans in any group fall on distinct banks: consecutive rows (the
    upper groups) and rows 2^k_bottom apart (the bottom group) alike."""
    return r ^ ((r >> plan.groups[-1][1]) & plan.swizzle)


@functools.lru_cache(maxsize=None)
def col_plan(h: int, w: int, cols: int = 0, threads: int = 0) -> ColPlan:
    """The fft_cols plan of (.., h, w) planes: strips of cols_per_block(h,
    w) columns (or `cols`, a power of two >= 16 / h whose strip fits a
    block), threads for two slot sets each up to C_THREADS (or `threads`,
    a multiple of 32 up to C_THREADS); the stage groups of
    t_stage_groups(log2 h)."""
    stages = check_length(h)
    check_kernel_length(h)
    cols = cols or cols_per_block(h, w)
    if cols & (cols - 1) or h * cols < T_SLOTS or cols > MAX_STRIP_COLS:
        raise ValueError(f"strip columns must be a power of two from {max(1, T_SLOTS // h)} "
                         f"to {MAX_STRIP_COLS}, got {cols}")
    lc = cols.bit_length() - 1
    ns = h * cols // T_SLOTS
    threads = threads or min(C_THREADS, -(-ns // 64) * 32)
    if threads % 32 or not 32 <= threads <= C_THREADS:
        raise ValueError(f"threads a block must be a multiple of 32 up to {C_THREADS}")
    plan = ColPlan(h, stages, lc, threads, t_stage_groups(stages))
    if plan.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError(f"a strip of {cols} columns of {h} rows does not fit a block")
    return plan


def col_slot_index(plan: ColPlan, group: tuple) -> tuple:
    """(row, column) in the strip of every (slot set, slot) of a stage
    group (s_lo, k): two (slot_sets, 16) int arrays. Slot j of slot set u
    holds element j mod 2^k of item u + (j >> k) * slot_sets."""
    s_lo, k = group
    ns = plan.slot_sets
    u = np.arange(ns, dtype=np.int64)[:, None]
    j = np.arange(T_SLOTS, dtype=np.int64)[None, :]
    it = u + (j >> k) * ns
    c = it & (plan.cols - 1)
    ub = it >> plan.lc
    row = (ub & ((1 << s_lo) - 1)) | ((j & ((1 << k) - 1)) << s_lo) | ((ub >> s_lo) << (s_lo + k))
    return row, np.broadcast_to(c, row.shape)


def col_bank_conflicts(plan: ColPlan, group: tuple) -> int:
    """The most threads of one warp that hit one bank with one shared
    access of a stage group (1: conflict-free); warps are 32 consecutive
    slot sets."""
    row, c = col_slot_index(plan, group)
    addr = col_row(plan, row) * plan.cols + c
    warp = np.arange(addr.shape[0])[:, None] // 32
    key = (warp * T_SLOTS + np.arange(T_SLOTS)[None, :]) * 32 + addr % 32
    return int(np.bincount(key.ravel()).max())


def _check_cols(re, im):
    if re.ndim < 2 or im.shape != re.shape:
        raise ValueError(f"need matching (..., H, W) planes, got {tuple(re.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError("planes must be float32")
    h = re.shape[-2]
    if h < 1 or h & (h - 1):
        raise ValueError(f"fft_cols needs a power-of-two height, got {h}")
    return h


def fft_cols_plain(re, im, *, inverse=False, ordering="natural"):
    """Plain version of `fft_cols`: the row stages over the transposed
    planes (the same tables and arithmetic as the kernel's column stages)."""
    h = _check_cols(re, im)
    natural = check_ordering(ordering)
    if h < 2:
        return re, im
    x_re, x_im = run_stages(re.transpose(-1, -2), im.transpose(-1, -2), inverse, (), natural)
    return x_re.transpose(-1, -2).contiguous(), x_im.transpose(-1, -2).contiguous()


def fft_cols(re, im, *, inverse=False, ordering="natural"):
    """1D DFT along axis -2 (the columns) of (..., H, W) float32 planes, H
    a power of two, any W; unscaled (B11, the JAX fft_cols_pallas).

    ordering: 'natural' (natural in and out: the first DIT group loads the
    bit-reversed rows, then the DIT stages with this direction's tables)
    or 'revorder' (forward DIF, bit-reversed out; inverse DIT,
    bit-reversed in). With `fft_rows(..., ordering='natural')` it makes
    the transpose-free 2D FFT. Operands contiguous; a ragged last strip of
    columns is bounds-checked in the kernel (the JAX kernel pads W with a
    copy). The kernel (csrc/fft_cols.cu) runs col_plan's stage groups."""
    if not on_cuda(re, im):
        return fft_cols_plain(re, im, inverse=inverse, ordering=ordering)
    h = _check_cols(re, im)
    natural = check_ordering(ordering)
    if h < 2:
        return re, im
    check_kernel_length(h)
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    if h * re.shape[-1] >= 1 << 31:
        raise ValueError("the kernel takes planes of fewer than 2^31 elements")
    return launch_cols(re, im, inverse, natural, col_plan(h, re.shape[-1]))


@functools.lru_cache(maxsize=256)
def _col_launch_args(plan: ColPlan, inverse: bool, device) -> tuple:
    """The table and plan pointers of one fft_cols launch, worked out once
    per plan, as _r_launch_args. The plan array stays alive in the cache."""
    t = tables(plan.h, inverse, device)
    c_plan = plan.c_plan()
    return (t.cos.data_ptr(), t.sin.data_ptr(), c_plan.ctypes.data), c_plan


def launch_cols(re, im, inverse, natural, plan: ColPlan):
    """One fft_cols launch of contiguous (..., H, W) planes with `plan`
    (col_plan; tools/rows_geometry.py passes its overrides)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    h, w = re.shape[-2:]
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    ptrs, _ = _col_launch_args(plan, bool(inverse), re.device)
    mode = 2 if natural else int(bool(inverse))  # natural, else revorder DIF / DIT
    err = _build.load().fft_cols_launch(
        re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        re.numel() // (h * w), h, w, plan.logh, plan.lc, plan.threads, mode, *ptrs,
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "fft_cols")
    launch_counts["fft_cols"] += 1
    return out_re, out_im
