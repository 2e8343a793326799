"""AV1 still-picture tile decoder (phase B..D of the AVIF ingest path):
the port's copy of the JAX package's utils/av1_decode.py, less its CDEF
chroma-direction fault.

From-scratch intra-frame reconstruction for the streams OpenCV 5.0
(libavif/libaom 3.x) writes: profile 0, 8-bit 4:2:0 lossy (BT.601 full
range) and 4:4:4 lossless (identity matrix), 64x64 superblocks, one
tile, no screen-content tools.  Covers the normative decode of spec
sections 5.11 (tile group), 7.11 (intra prediction incl.
filter-intra/CfL/edge filter), 7.12 (dequant with quantizer matrices),
7.13 (inverse transforms, via av1_transform), 7.14 (deblocking) and
7.15.1 (CDEF).  Out-of-scope tools (inter frames, palette, intrabc,
segmentation, superres, loop restoration, film grain) raise precise
contract ValueErrors.

Verification ladder: tests/dav1d_oracle.py decodes the same OBUs with
selectable in-loop filters, so reconstruction, +deblock and +CDEF are
each pinned plane-exact (tests/test_torch_codecs_avif.py).

One change from JAX: CDEF filters chroma along the luma direction
remapped by the spec's Cdef_Uv_Dir for the stream's subsampling
(`_cdef_uv_direction`). JAX applies the 4:2:2 remap to 4:2:0 streams,
which libdav1d does not; encoders that leave chroma CDEF off (libaom's
still encoder) never reach the difference.

Entropy tables: _av1_tables.py (generated from the rodata of system AV1
decoders); range coder: av1_msac.Msac.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host import _av1_tables as T
from fft_restoration_tpu_torch.host.av1 import FrameHeader, SequenceHeader
from fft_restoration_tpu_torch.host.av1_msac import Msac
from fft_restoration_tpu_torch.host.av1_transform import inverse_transform_2d

__all__ = ["decode_frame"]

# ------------------------------------------------------------- enumerations

# Block sizes (spec BLOCK_SIZES_ALL order)
BS_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16]
BS_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4]
B4X4, B4X8, B8X4, B8X8 = 0, 1, 2, 3
B8X16, B16X8, B16X16, B16X32, B32X16, B32X32 = 4, 5, 6, 7, 8, 9
B32X64, B64X32, B64X64 = 10, 11, 12
B64X128, B128X64, B128X128 = 13, 14, 15
B4X16, B16X4, B8X32, B32X8, B16X64, B64X16 = 16, 17, 18, 19, 20, 21

# Partitions
P_NONE, P_HORZ, P_VERT, P_SPLIT = 0, 1, 2, 3
P_HORZ_A, P_HORZ_B, P_VERT_A, P_VERT_B, P_HORZ_4, P_VERT_4 = 4, 5, 6, 7, 8, 9

_SQUARES = {B8X8: 0, B16X16: 1, B32X32: 2, B64X64: 3, B128X128: 4}
_HORZ_SUB = {B8X8: B8X4, B16X16: B16X8, B32X32: B32X16, B64X64: B64X32}
_VERT_SUB = {B8X8: B4X8, B16X16: B8X16, B32X32: B16X32, B64X64: B32X64}
_SPLIT_SUB = {B8X8: B4X4, B16X16: B8X8, B32X32: B16X16, B64X64: B32X32}
_HORZ4_SUB = {B16X16: B16X4, B32X32: B32X8, B64X64: B64X16}
_VERT4_SUB = {B16X16: B4X16, B32X32: B8X32, B64X64: B16X64}

# 4:2:0 chroma block size (spec Subsampled_Size[bsize][1][1])
SUB_420 = {
    B4X4: B4X4, B4X8: B4X4, B8X4: B4X4, B8X8: B4X4,
    B8X16: B4X8, B16X8: B8X4, B16X16: B8X8, B16X32: B8X16,
    B32X16: B16X8, B32X32: B16X16, B32X64: B16X32, B64X32: B32X16,
    B64X64: B32X32, B4X16: B4X8, B16X4: B8X4, B8X32: B4X16,
    B32X8: B16X4, B16X64: B8X32, B64X16: B32X8,
}

# Transform sizes (spec TX_SIZES_ALL order)
TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = 0, 1, 2, 3, 4

# Largest rect tx fitting each block (spec Max_Tx_Size_Rect)
MAX_TX_RECT = [0, 5, 6, 1, 7, 8, 2, 9, 10, 3, 11, 12, 4, 4, 4, 4, 13, 14, 15, 16, 17, 18]

# One-level tx split (spec Split_Tx_Size)
SPLIT_TX = [0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10]

# 64-limb sizes decode only their 32-limb corner (spec Adjusted_Tx_Size)
ADJ_TX = {TX_64X64: TX_32X32, 12: TX_32X32, 11: TX_32X32, 18: 10, 17: 9}

# Intra modes
DC, V, H, D45, D135, D113, D157, D203, D67 = range(9)
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = 9, 10, 11, 12
UV_CFL = 13
INTRA_MODE_CTX = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
MODE_ANGLE = {V: 90, H: 180, D45: 45, D135: 135, D113: 113, D157: 157, D203: 203, D67: 67}
_SMOOTH_MODES = (SMOOTH, SMOOTH_V, SMOOTH_H)

# Tx types (match av1_transform's enum)
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST = 0, 1, 2, 3
IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST = 9, 10, 11, 12, 13, 14, 15
# symbol -> tx type for the two intra tx sets (spec Tx_Type_Intra_Inv_Set1/2)
TX_INV_SET1 = [IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST]
TX_INV_SET2 = [IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST]
# intra mode -> implied chroma tx type (spec Mode_To_Txfm)
MODE_TO_TXFM = [DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT,
                DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                ADST_ADST, DCT_DCT]
# filter-intra mode -> intra dir used for tx-type context (spec)
FIMODE_TO_DIR = [DC, V, H, D157, DC]

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


def tx_sqr_up_ctx(txs: int) -> int:
    """log2(max dim)-2 capped at TX_64X64 — the coeff-cdf tx-size axis."""
    return min(max(TX_W[txs], TX_H[txs]).bit_length() - 3, 4)


def _q_ctx(base_q: int) -> int:
    if base_q <= 20:
        return 0
    if base_q <= 60:
        return 1
    if base_q <= 120:
        return 2
    return 3


_SCANS = {
    (4, 4): T.SCAN_4X4, (8, 8): T.SCAN_8X8, (16, 16): T.SCAN_16X16,
    (32, 32): T.SCAN_32X32, (4, 8): T.SCAN_4X8, (8, 4): T.SCAN_8X4,
    (8, 16): T.SCAN_8X16, (16, 8): T.SCAN_16X8, (16, 32): T.SCAN_16X32,
    (32, 16): T.SCAN_32X16, (4, 16): T.SCAN_4X16, (16, 4): T.SCAN_16X4,
    (8, 32): T.SCAN_8X32, (32, 8): T.SCAN_32X8,
}
_EOB_PT = [T.EOB_PT_16, T.EOB_PT_32, T.EOB_PT_64, T.EOB_PT_128,
           T.EOB_PT_256, T.EOB_PT_512, T.EOB_PT_1024]

# smooth-predictor weight row offsets by block dimension
_SMW_OFF = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


class Cdfs:
    """Mutable per-frame CDF state: deep copies of the default tables in
    the aom CDF_SIZE layout (_av1_tables docstring), adapted in place by
    Msac.symbol.  Indexing helpers keep the table axes documented in one
    place."""

    def __init__(self, base_q: int):
        q = _q_ctx(base_q)
        L = lambda a: a.tolist()  # noqa: E731
        self.partition = L(T.PARTITION)
        self.kf_y = [L(r) for r in T.KF_Y_MODE]
        self.uv_mode = [L(r) for r in T.UV_MODE]
        self.angle_delta = L(T.ANGLE_DELTA)
        self.cfl_sign = L(T.CFL_SIGN)[0]
        self.cfl_alpha = L(T.CFL_ALPHA)
        self.skip = L(T.SKIP)
        self.filter_intra = L(T.FILTER_INTRA)
        self.filter_intra_mode = L(T.FILTER_INTRA_MODE)[0]
        self.delta_q = L(T.DELTA_Q)[0]
        self.tx_size = [L(r) for r in T.TX_SIZE]
        self.intra_tx1 = [L(r) for r in T.INTRA_TX_TYPE1]
        self.intra_tx2 = [L(r) for r in T.INTRA_TX_TYPE2]
        self.eob_pt = [[L(r) for r in t[q]] for t in _EOB_PT]  # [sz][pt][ctx]
        self.base_eob = [[L(r) for r in s] for s in T.COEFF_BASE_EOB[q]]
        self.base = [[L(r) for r in s] for s in T.COEFF_BASE[q]]
        self.br = [[L(r) for r in s] for s in T.COEFF_BR[q]]
        self.dc_sign = [L(r) for r in T.DC_SIGN[q]]
        self.eob_extra = [[L(r) for r in s] for s in T.EOB_EXTRA[q]]
        self.txb_skip = [L(r) for r in T.TXB_SKIP[q]]


class TileDecoder:
    """One-tile intra frame decode (spec 5.11 + 7.11-7.15).

    Planes are int32 working buffers padded to whole-superblock mi
    dimensions; `decode()` returns them cropped to the frame."""

    def __init__(self, seq: SequenceHeader, hdr: FrameHeader, data: bytes):
        if hdr.allow_intrabc:
            raise ValueError("AV1 intra block copy is out of scope")
        if hdr.allow_screen_content_tools and not hdr.coded_lossless:
            raise ValueError("AV1 palette coding is out of scope")
        self.seq = seq
        self.hdr = hdr
        self.m = Msac(data, allow_update_cdf=not hdr.disable_cdf_update)
        self.cdf = Cdfs(hdr.base_q_idx)
        self.mi_rows, self.mi_cols = hdr.mi_rows, hdr.mi_cols
        self.sb4 = 32 if seq.use_128x128_superblock else 16
        self.sb_size = B128X128 if seq.use_128x128_superblock else B64X64
        self.nplanes = seq.num_planes
        self.ss_x = seq.subsampling_x if not seq.monochrome else 1
        self.ss_y = seq.subsampling_y if not seq.monochrome else 1
        r4 = -(-self.mi_rows // self.sb4) * self.sb4
        c4 = -(-self.mi_cols // self.sb4) * self.sb4
        self.pad_r4, self.pad_c4 = r4, c4
        self.planes = []
        for p in range(self.nplanes):
            sx = self.ss_x if p else 0
            sy = self.ss_y if p else 0
            self.planes.append(
                np.zeros((r4 * 4 >> sy, c4 * 4 >> sx), np.int32)
            )
        # mi grids
        g = lambda fill=0, dt=np.int32: np.full((r4, c4), fill, dt)  # noqa: E731
        self.mi_size = g(B64X64)
        self.y_mode = g(DC)
        self.uv_mode_g = g(DC)
        self.skip_g = g(1)
        self.tx_w4 = g(16)  # luma tx dims per 4x4, for deblocking
        self.tx_h4 = g(16)
        self.blk_left = g(0, np.uint8)  # mi is its block's left column
        self.blk_top = g(0, np.uint8)  # mi is its block's top row
        # tx-block edge flags for the loop filter, per plane geometry
        self.txe_l = [None, None]  # [luma(mi), chroma(chroma-4units)]
        self.txe_t = [None, None]
        # entropy neighbour state, per plane in plane-4x4 units
        self.abv_lvl = [np.zeros(c4 * 4 >> (self.ss_x if p else 0) >> 2, np.int32) for p in range(3)]
        self.lft_lvl = [np.zeros(r4 * 4 >> (self.ss_y if p else 0) >> 2, np.int32) for p in range(3)]
        self.abv_dc = [np.zeros_like(self.abv_lvl[p]) for p in range(3)]
        self.lft_dc = [np.zeros_like(self.lft_lvl[p]) for p in range(3)]
        self.decoded = [np.zeros_like(self.planes[p], shape=((r4 * 4 >> (self.ss_y if p else 0)) // 4, (c4 * 4 >> (self.ss_x if p else 0)) // 4), dtype=np.uint8) for p in range(self.nplanes)]
        self.cdef_idx = np.full((r4 // 16, c4 // 16), -1, np.int32)
        cw4 = c4 * 4 >> self.ss_x >> 2
        ch4 = r4 * 4 >> self.ss_y >> 2
        self.txe_l = [np.zeros((r4, c4), np.uint8),
                      np.zeros((ch4, cw4), np.uint8)]
        self.txe_t = [np.zeros((r4, c4), np.uint8),
                      np.zeros((ch4, cw4), np.uint8)]
        self.tx_uv_w4 = np.full((ch4, cw4), 8, np.int32)
        self.tx_uv_h4 = np.full((ch4, cw4), 8, np.int32)
        self._scan_cache = {}
        self.b_has_chroma = False
        # tx-size-context neighbour state (aom above/left_txfm_context):
        # per-4x4 stored tx width/height in pixels; block dims when skip
        self.abv_txw = np.full(c4, 64, np.int32)
        self.lft_txh = np.full(r4, 64, np.int32)
        self.cur_qidx = hdr.base_q_idx
        self.read_deltas = False
        # current-block fields filled by _decode_block
        self.b_ymode = DC
        self.b_uvmode = DC
        self.b_angle_y = 0
        self.b_angle_uv = 0
        self.b_filter_intra = -1
        self.b_cfl_alpha_u = 0
        self.b_cfl_alpha_v = 0
        self.b_skip = 0
        self.b_qidx = hdr.base_q_idx
        self.tx_types = {}  # (y4, x4) -> luma tx type of that tx block

    # ------------------------------------------------------------ partition

    def decode(self):
        for r in range(0, self.mi_rows, self.sb4):
            for c in range(0, self.mi_cols, self.sb4):
                self.read_deltas = self.hdr.delta_q_present
                self._decode_partition(r, c, self.sb_size)
        return self.planes

    def _avail_u(self, r):
        return r > 0

    def _avail_l(self, c):
        return c > 0

    def _partition_ctx(self, r, c, bsize):
        bsl = BS_W4[bsize].bit_length() - 1  # 1..4 for 8..64
        above = 1 if r > 0 and BS_W4[self.mi_size[r - 1, c]].bit_length() - 1 < bsl else 0
        left = 1 if c > 0 and BS_H4[self.mi_size[r, c - 1]].bit_length() - 1 < bsl else 0
        return (bsl - 1) * 4 + left * 2 + above

    def _gather_split(self, cdf_row, nsyms, horz_alike, bsize):
        """aom partition_gather_*_alike: 2-symbol split-vs-rect read at
        frame boundaries.  Returns True for SPLIT."""
        def prob(i):
            lo = cdf_row[i - 1] if i > 0 else 32768
            return lo - cdf_row[i]
        # aom partition_gather_*_alike: the 2-symbol ICDF is the summed
        # probability of the gathered set (AOM_ICDF re-inverts the 32768-sum).
        # Bottom edge asks "is the visible TOP half split vertically?", so
        # it gathers the VERT-alike set, and vice versa (pinned vs dav1d:
        # the mirrored sets mis-parse every partial-superblock stream).
        if horz_alike:  # bottom edge: HORZ vs SPLIT -> vert-alike set
            kinds = [P_VERT, P_SPLIT, P_HORZ_A, P_VERT_A, P_VERT_B]
            if bsize != B128X128:
                kinds.append(P_VERT_4)
        else:  # right edge: VERT vs SPLIT -> horz-alike set
            kinds = [P_HORZ, P_SPLIT, P_HORZ_A, P_HORZ_B, P_VERT_A]
            if bsize != B128X128:
                kinds.append(P_HORZ_4)
        f = sum(prob(i) for i in kinds)
        return self.m.bool_prob(f) == 1

    def _decode_partition(self, r, c, bsize):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        num4 = BS_W4[bsize]
        half, quarter = num4 >> 1, num4 >> 2
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        if bsize == B4X4:
            self._decode_block(r, c, bsize)
            return
        ctx = self._partition_ctx(r, c, bsize)
        nsyms = 4 if bsize == B8X8 else (8 if bsize == B128X128 else 10)
        if has_rows and has_cols:
            part = self.m.symbol(self.cdf.partition[ctx], nsyms)
        elif has_cols:
            part = P_SPLIT if self._gather_split(self.cdf.partition[ctx], nsyms, True, bsize) else P_HORZ
        elif has_rows:
            part = P_SPLIT if self._gather_split(self.cdf.partition[ctx], nsyms, False, bsize) else P_VERT
        else:
            part = P_SPLIT
        sq = bsize
        if part == P_NONE:
            self._decode_block(r, c, sq)
        elif part == P_HORZ:
            self._decode_block(r, c, _HORZ_SUB[sq])
            if has_rows:
                self._decode_block(r + half, c, _HORZ_SUB[sq])
        elif part == P_VERT:
            self._decode_block(r, c, _VERT_SUB[sq])
            if has_cols:
                self._decode_block(r, c + half, _VERT_SUB[sq])
        elif part == P_SPLIT:
            sub = _SPLIT_SUB[sq]
            self._decode_partition(r, c, sub)
            self._decode_partition(r, c + half, sub)
            self._decode_partition(r + half, c, sub)
            self._decode_partition(r + half, c + half, sub)
        elif part == P_HORZ_A:
            self._decode_block(r, c, _SPLIT_SUB[sq])
            self._decode_block(r, c + half, _SPLIT_SUB[sq])
            self._decode_block(r + half, c, _HORZ_SUB[sq])
        elif part == P_HORZ_B:
            self._decode_block(r, c, _HORZ_SUB[sq])
            self._decode_block(r + half, c, _SPLIT_SUB[sq])
            self._decode_block(r + half, c + half, _SPLIT_SUB[sq])
        elif part == P_VERT_A:
            self._decode_block(r, c, _SPLIT_SUB[sq])
            self._decode_block(r + half, c, _SPLIT_SUB[sq])
            self._decode_block(r, c + half, _VERT_SUB[sq])
        elif part == P_VERT_B:
            self._decode_block(r, c, _VERT_SUB[sq])
            self._decode_block(r, c + half, _SPLIT_SUB[sq])
            self._decode_block(r + half, c + half, _SPLIT_SUB[sq])
        elif part == P_HORZ_4:
            sub = _HORZ4_SUB[sq]
            for i in range(4):
                rr = r + i * quarter
                if rr >= self.mi_rows:
                    break
                self._decode_block(rr, c, sub)
        elif part == P_VERT_4:
            sub = _VERT4_SUB[sq]
            for i in range(4):
                cc = c + i * quarter
                if cc >= self.mi_cols:
                    break
                self._decode_block(r, cc, sub)
        else:
            raise ValueError(f"corrupt AV1: partition {part}")

    # ----------------------------------------------------------- block modes

    def _read_delta_qindex(self, bsize, skip):
        if not self.read_deltas:
            return
        if bsize == self.sb_size and skip:
            return
        ab = self.m.symbol(self.cdf.delta_q, 4)
        if ab == 3:
            rem = self.m.literal(3) + 1
            ab = self.m.literal(rem) + (1 << rem) + 1
        if ab:
            sign = self.m.literal(1)
            delta = -ab if sign else ab
            self.cur_qidx = _clip3(
                1, 255, self.cur_qidx + (delta << self.hdr.delta_q_res)
            )

    def _read_cdef(self, r, c, skip):
        h = self.hdr
        if skip or h.coded_lossless or not self.seq.enable_cdef:
            return
        r1, c1 = r & ~15, c & ~15
        if self.cdef_idx[r1 >> 4, c1 >> 4] < 0:
            self.cdef_idx[r1 >> 4, c1 >> 4] = self.m.literal(h.cdef_bits)

    def _decode_block(self, r, c, bsize):
        bw4, bh4 = BS_W4[bsize], BS_H4[bsize]
        has_chroma = self.nplanes > 1 and (
            bh4 > 1 or (r & 1) or not self.ss_y
        ) and (bw4 > 1 or (c & 1) or not self.ss_x)

        # skip
        sctx = (1 if r > 0 and self.skip_g[r - 1, c] else 0) + (
            1 if c > 0 and self.skip_g[r, c - 1] else 0
        )
        skip = self.m.symbol(self.cdf.skip[sctx], 2)
        self.b_has_chroma = has_chroma
        self.b_r, self.b_c = r, c
        self._read_cdef(r, c, skip)
        self._read_delta_qindex(bsize, skip)
        self.read_deltas = False
        self.b_skip = skip
        self.b_qidx = self.cur_qidx

        # luma mode
        above = self.y_mode[r - 1, c] if r > 0 else DC
        left = self.y_mode[r, c - 1] if c > 0 else DC
        ymode = self.m.symbol(
            self.cdf.kf_y[INTRA_MODE_CTX[above]][INTRA_MODE_CTX[left]], 13
        )
        self.b_ymode = ymode
        self.b_angle_y = 0
        use_angle = bsize >= B8X8
        if use_angle and ymode in MODE_ANGLE:
            self.b_angle_y = self.m.symbol(self.cdf.angle_delta[ymode - V], 7) - 3

        # chroma mode
        self.b_uvmode = DC
        self.b_angle_uv = 0
        self.b_cfl_alpha_u = self.b_cfl_alpha_v = 0
        if has_chroma:
            if self.hdr.coded_lossless:
                cfl_ok = bsize == B4X4
            else:
                cfl_ok = bw4 * 4 <= 32 and bh4 * 4 <= 32
            uvmode = self.m.symbol(self.cdf.uv_mode[1 if cfl_ok else 0][ymode], 13 + (1 if cfl_ok else 0))
            self.b_uvmode = uvmode
            if uvmode == UV_CFL:
                js = self.m.symbol(self.cdf.cfl_sign, 8)
                sign_u, sign_v = (js + 1) // 3, (js + 1) % 3
                if sign_u:
                    idx = self.m.symbol(self.cdf.cfl_alpha[js - 2], 16)
                    self.b_cfl_alpha_u = (idx + 1) * (1 if sign_u == 2 else -1)
                if sign_v:
                    idx = self.m.symbol(self.cdf.cfl_alpha[sign_v * 3 + sign_u - 3], 16)
                    self.b_cfl_alpha_v = (idx + 1) * (1 if sign_v == 2 else -1)
            elif use_angle and uvmode in MODE_ANGLE:
                self.b_angle_uv = self.m.symbol(self.cdf.angle_delta[uvmode - V], 7) - 3

        # filter intra
        self.b_filter_intra = -1
        if (
            self.seq.enable_filter_intra
            and ymode == DC
            and bw4 * 4 <= 32
            and bh4 * 4 <= 32
        ):
            if self.m.symbol(self.cdf.filter_intra[bsize], 2):
                self.b_filter_intra = self.m.symbol(self.cdf.filter_intra_mode, 5)

        # tx size (TX_MODE_LARGEST / TX_MODE_4X4; tx_mode_select reads depth)
        if self.hdr.coded_lossless:
            txs = TX_4X4
        else:
            txs = MAX_TX_RECT[bsize]
            if self.hdr.tx_mode_select and bsize > B4X4:
                txs = self._read_tx_size(r, c, bsize)

        # bookkeeping grids over the block extent
        r1, c1 = min(r + bh4, self.pad_r4), min(c + bw4, self.pad_c4)
        self.mi_size[r:r1, c:c1] = bsize
        self.blk_left[r:r1, c] = 1
        self.blk_top[r, c:c1] = 1
        self.y_mode[r:r1, c:c1] = ymode
        self.uv_mode_g[r:r1, c:c1] = self.b_uvmode
        self.skip_g[r:r1, c:c1] = skip
        self.tx_w4[r:r1, c:c1] = TX_W[txs] >> 2
        self.tx_h4[r:r1, c:c1] = TX_H[txs] >> 2
        self.abv_txw[c:c1] = bw4 * 4 if skip else TX_W[txs]
        self.lft_txh[r:r1] = bh4 * 4 if skip else TX_H[txs]

        self._residual(r, c, bsize, txs)

    def _read_tx_size(self, r, c, bsize):
        """tx_depth symbol for TX_MODE_SELECT frames (spec read_tx_size).
        cv2's still encoder never selects this mode; kept for other
        encoders' streams."""
        max_rect = MAX_TX_RECT[bsize]
        depth_cap, t = 0, max_rect
        while t != TX_4X4 and depth_cap < 2:
            depth_cap += 1
            t = SPLIT_TX[t]
        t = max_rect
        d = 0
        while t != TX_4X4:
            d += 1
            t = SPLIT_TX[t]
        cat = min(d - 1, 3)
        if r > 0 and c > 0:
            ctx = int(self.abv_txw[c] >= TX_W[max_rect]) + int(
                self.lft_txh[r] >= TX_H[max_rect]
            )
        elif r > 0:
            ctx = int(self.abv_txw[c] >= TX_W[max_rect])
        elif c > 0:
            ctx = int(self.lft_txh[r] >= TX_H[max_rect])
        else:
            ctx = 0
        depth = self.m.symbol(self.cdf.tx_size[cat][ctx], depth_cap + 1)
        txs = max_rect
        for _ in range(depth):
            txs = SPLIT_TX[txs]
        return txs

    # ------------------------------------------------------------- residual

    def _uv_tx(self, pbsize):
        if self.hdr.coded_lossless:
            return TX_4X4
        t = MAX_TX_RECT[pbsize]
        if TX_W[t] == 64 or TX_H[t] == 64:
            if TX_W[t] == 16:
                return 9  # TX_16X32
            if TX_H[t] == 16:
                return 10  # TX_32X16
            return TX_32X32
        return t

    def _residual(self, r, c, bsize, txs):
        np_ = self.nplanes if self.b_has_chroma else 1
        for plane in range(np_):
            sx = self.ss_x if plane else 0
            sy = self.ss_y if plane else 0
            if plane == 0:
                ptx = txs
                base_x, base_y = c * 4, r * 4
                n4w, n4h = BS_W4[bsize], BS_H4[bsize]
            else:
                pbsize = SUB_420[bsize] if (sx and sy) else bsize
                ptx = self._uv_tx(pbsize)
                base_x = (c >> sx) * 4
                base_y = (r >> sy) * 4
                n4w, n4h = BS_W4[pbsize], BS_H4[pbsize]
                if plane == 1:
                    self.tx_uv_w4[base_y >> 2:(base_y >> 2) + n4h, base_x >> 2:(base_x >> 2) + n4w] = TX_W[ptx] >> 2
                    self.tx_uv_h4[base_y >> 2:(base_y >> 2) + n4h, base_x >> 2:(base_x >> 2) + n4w] = TX_H[ptx] >> 2
            stepx, stepy = TX_W[ptx] >> 2, TX_H[ptx] >> 2
            for yy in range(0, n4h, stepy):
                for xx in range(0, n4w, stepx):
                    self._transform_block(
                        plane, base_x + xx * 4, base_y + yy * 4, ptx,
                        n4w, n4h,
                    )

    def _transform_block(self, plane, x, y, ptx, n4w, n4h):
        sx = self.ss_x if plane else 0
        sy = self.ss_y if plane else 0
        if x >= (self.mi_cols * 4) >> sx or y >= (self.mi_rows * 4) >> sy:
            return  # spec 5.11.35: tx blocks past the frame mi area are not coded
        w, h = TX_W[ptx], TX_H[ptx]
        if plane < 2:  # loop-filter tx edges (chroma planes share geometry)
            g = 0 if plane == 0 else 1
            self.txe_l[g][y >> 2:(y + h) >> 2, x >> 2] = 1
            self.txe_t[g][y >> 2, x >> 2:(x + w) >> 2] = 1
        arr = self.planes[plane]
        pred = self._predict(plane, x, y, w, h, ptx)
        arr[y:y + h, x:x + w] = pred
        if not self.b_skip:
            self._coeffs(plane, x, y, ptx, n4w, n4h)
        else:
            x4, y4 = x >> 2, y >> 2
            self.abv_lvl[plane][x4:x4 + (w >> 2)] = 0
            self.lft_lvl[plane][y4:y4 + (h >> 2)] = 0
            self.abv_dc[plane][x4:x4 + (w >> 2)] = 0
            self.lft_dc[plane][y4:y4 + (h >> 2)] = 0
        self.decoded[plane][y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2] = 1

    # ---------------------------------------------------------- coefficients

    def _tx_set(self, ptx):
        up = max(TX_W[ptx], TX_H[ptx])
        if up >= 32:
            return 0
        if self.hdr.reduced_tx_set:
            return 2
        return 2 if min(TX_W[ptx], TX_H[ptx]) == 16 else 1

    def _read_tx_type(self, ptx):
        ts = self._tx_set(ptx)
        if ts == 0 or self.b_qidx == 0:
            return DCT_DCT
        mode = (
            FIMODE_TO_DIR[self.b_filter_intra]
            if self.b_filter_intra >= 0
            else self.b_ymode
        )
        sqr = min(min(TX_W[ptx], TX_H[ptx]).bit_length() - 3, 3)
        if ts == 1:
            return TX_INV_SET1[self.m.symbol(self.cdf.intra_tx1[sqr][mode], 7)]
        return TX_INV_SET2[self.m.symbol(self.cdf.intra_tx2[sqr][mode], 5)]

    def _chroma_tx_type(self, ptx):
        if self.hdr.coded_lossless:
            return DCT_DCT
        if max(TX_W[ptx], TX_H[ptx]) >= 32:
            return DCT_DCT
        return MODE_TO_TXFM[self.b_uvmode]

    def _coeffs(self, plane, x, y, ptx, n4w, n4h):
        m, cdf = self.m, self.cdf
        ptype = 1 if plane else 0
        x4, y4 = x >> 2, y >> 2
        tw4, th4 = TX_W[ptx] >> 2, TX_H[ptx] >> 2
        tctx = (
            min(TX_W[ptx], TX_H[ptx]).bit_length() - 3
            + max(min(max(TX_W[ptx], TX_H[ptx]).bit_length() - 3, 4), 0)
            + 1
        ) >> 1

        # --- all_zero context (spec get_txb_skip_ctx)
        if plane == 0:
            if n4w == tw4 and n4h == th4:
                ctx = 0
            else:
                top = int(self.abv_lvl[0][x4:x4 + tw4].max(initial=0))
                left = int(self.lft_lvl[0][y4:y4 + th4].max(initial=0))
                ctx = int(T.SKIP_CONTEXTS[min(top, 4)][min(left, 4)])
        else:
            ca = int(
                self.abv_lvl[plane][x4:x4 + tw4].any()
                or self.abv_dc[plane][x4:x4 + tw4].any()
            )
            cl = int(
                self.lft_lvl[plane][y4:y4 + th4].any()
                or self.lft_dc[plane][y4:y4 + th4].any()
            )
            not_one = int(n4w > tw4 or n4h > th4)
            ctx = 7 + 3 * not_one + ca + cl
        all_zero = m.symbol(cdf.txb_skip[tctx][ctx], 2)
        if all_zero:
            self.abv_lvl[plane][x4:x4 + tw4] = 0
            self.lft_lvl[plane][y4:y4 + th4] = 0
            self.abv_dc[plane][x4:x4 + tw4] = 0
            self.lft_dc[plane][y4:y4 + th4] = 0
            return

        if self.hdr.coded_lossless:
            tx_type = DCT_DCT  # signalled path unused: lossless is WHT
        elif plane == 0:
            tx_type = self._read_tx_type(ptx)
        else:
            tx_type = self._chroma_tx_type(ptx)
        cls = tx_class(tx_type)

        adj = ADJ_TX.get(ptx, ptx)
        aw, ah = TX_W[adj], TX_H[adj]
        bwl = aw.bit_length() - 1
        scan = self._scan(aw, ah, cls)

        # --- EOB
        emul = (aw * ah).bit_length() - 5  # log2(area)-4
        eob_cdf = cdf.eob_pt[emul][ptype][0 if cls == TX_CLASS_2D else 1]
        pt = m.symbol(eob_cdf, emul + 5) + 1
        eob = pt if pt < 2 else (1 << (pt - 2)) + 1
        if pt >= 3:
            if m.symbol(cdf.eob_extra[tctx][ptype][pt - 3], 2):
                eob += 1 << (pt - 3)
            for i in range(1, pt - 2):
                if m.literal(1):
                    eob += 1 << (pt - 3 - i)

        # --- levels, reverse scan
        lv = [[0] * (aw + 5) for _ in range(ah + 5)]
        quant = [0] * (aw * ah)
        area = aw * ah
        grids = T.LO_CTX_OFFSETS
        grid = grids[0 if aw == ah else (1 if aw > ah else 2)]
        base_cdf = cdf.base[tctx][ptype]
        br_cdf = cdf.br[min(tctx, 3)][ptype]
        beob_cdf = cdf.base_eob[tctx][ptype]
        for si in range(eob - 1, -1, -1):
            pos = scan[si]
            row = pos >> bwl
            col = pos - (row << bwl)
            lrow, lrow1, lrow2 = lv[row], lv[row + 1], lv[row + 2]
            if si == eob - 1:
                if si == 0:
                    ec = 0
                elif si <= area // 8:
                    ec = 1
                elif si <= area // 4:
                    ec = 2
                else:
                    ec = 3
                lvl = m.symbol(beob_cdf[ec], 3) + 1
            else:
                a = lrow[col + 1]
                b_ = lrow1[col]
                mag = (a if a < 3 else 3) + (b_ if b_ < 3 else 3)
                if cls == TX_CLASS_2D:
                    if pos == 0:
                        bc = 0
                    else:
                        a = lrow1[col + 1]
                        b_ = lrow[col + 2]
                        c_ = lrow2[col]
                        mag += (
                            (a if a < 3 else 3)
                            + (b_ if b_ < 3 else 3)
                            + (c_ if c_ < 3 else 3)
                        )
                        mag = (mag + 1) >> 1
                        bc = (mag if mag < 4 else 4) + grid[
                            row if row < 4 else 4][col if col < 4 else 4]
                elif cls == TX_CLASS_HORIZ:
                    a = lrow[col + 2]
                    b_ = lrow[col + 3]
                    c_ = lrow[col + 4]
                    mag += (
                        (a if a < 3 else 3)
                        + (b_ if b_ < 3 else 3)
                        + (c_ if c_ < 3 else 3)
                    )
                    mag = (mag + 1) >> 1
                    bc = (mag if mag < 4 else 4) + 26 + (
                        0 if col == 0 else (5 if col == 1 else 10)
                    )
                else:
                    a = lrow2[col]
                    b_ = lv[row + 3][col]
                    c_ = lv[row + 4][col]
                    mag += (
                        (a if a < 3 else 3)
                        + (b_ if b_ < 3 else 3)
                        + (c_ if c_ < 3 else 3)
                    )
                    mag = (mag + 1) >> 1
                    bc = (mag if mag < 4 else 4) + 26 + (
                        0 if row == 0 else (5 if row == 1 else 10)
                    )
                lvl = m.symbol(base_cdf[bc], 4)
            if lvl > 2:
                mag = lrow[col + 1] + lrow1[col]
                if cls == TX_CLASS_2D:
                    mag += lrow1[col + 1]
                elif cls == TX_CLASS_HORIZ:
                    mag += lrow[col + 2]
                else:
                    mag += lrow2[col]
                mag = (mag + 1) >> 1
                if mag > 6:
                    mag = 6
                if pos == 0:
                    brc = mag
                elif (
                    (row < 2 and col < 2)
                    if cls == TX_CLASS_2D
                    else ((col == 0) if cls == TX_CLASS_HORIZ else (row == 0))
                ):
                    brc = mag + 7
                else:
                    brc = mag + 14
                for _ in range(4):
                    b = m.symbol(br_cdf[brc], 4)
                    lvl += b
                    if b < 3:
                        break
            lrow[col] = lvl
            quant[pos] = lvl

        # --- signs, golomb tail, dequant
        qidx = self.b_qidx
        h_ = self.hdr
        if plane == 0:
            dcd, acd = h_.delta_q_y_dc, 0
            qml = h_.qm_y
        elif plane == 1:
            dcd, acd = h_.delta_q_u_dc, h_.delta_q_u_ac
            qml = h_.qm_u
        else:
            dcd, acd = h_.delta_q_v_dc, h_.delta_q_v_ac
            qml = h_.qm_v
        dcq = int(T.DC_Q[_clip3(0, 255, qidx + dcd)])
        acq = int(T.AC_Q[_clip3(0, 255, qidx + acd)])
        use_qm = (
            h_.using_qmatrix and qml < 15 and tx_type < IDTX
            and not self.hdr.coded_lossless
        )
        if use_qm:
            off = T.QM_OFFSET[(aw, ah)]
            qmv = T.QM[qml][ptype][off:off + aw * ah]
        full_area = TX_W[ptx] * TX_H[ptx]
        shift = (1 if full_area > 256 else 0) + (1 if full_area > 1024 else 0)
        coeffs = [[0] * TX_W[ptx] for _ in range(TX_H[ptx])]
        cul = 0
        dc_val = 0
        for si in range(eob):
            pos = scan[si]
            lvl = quant[pos]
            if lvl == 0:
                continue
            if si == 0:
                dsum = int(self.abv_dc[plane][x4:x4 + tw4].sum()) + int(
                    self.lft_dc[plane][y4:y4 + th4].sum()
                )
                dctx = 0 if dsum == 0 else (1 if dsum < 0 else 2)
                sign = m.symbol(cdf.dc_sign[ptype][dctx], 2)
            else:
                sign = m.bool_equi()
            if lvl > 14:
                lvl += m.golomb()
            cul += lvl
            dqv = dcq if pos == 0 else acq
            if use_qm:
                dqv = (dqv * int(qmv[pos]) + 16) >> 5
            v = ((lvl * dqv) & 0xFFFFFF) >> shift
            if sign:
                v = -v
            if si == 0:
                dc_val = v
            coeffs[pos >> bwl][pos - ((pos >> bwl) << bwl)] = v

        res = inverse_transform_2d(
            coeffs, tx_type, TX_W[ptx], TX_H[ptx], self.hdr.coded_lossless
        )
        arr = self.planes[plane]
        w, hh = TX_W[ptx], TX_H[ptx]
        blk = arr[y:y + hh, x:x + w]
        np.clip(blk + np.asarray(res, np.int32), 0, 255, out=blk)

        cul = min(63, cul)
        self.abv_lvl[plane][x4:x4 + tw4] = cul
        self.lft_lvl[plane][y4:y4 + th4] = cul
        dcat = 0 if dc_val == 0 else (-1 if dc_val < 0 else 1)
        self.abv_dc[plane][x4:x4 + tw4] = dcat
        self.lft_dc[plane][y4:y4 + th4] = dcat

    def _scan(self, aw, ah, cls):
        if cls == TX_CLASS_VERT:
            return range(aw * ah)  # row-major
        if cls == TX_CLASS_HORIZ:
            key = ("mcol", aw, ah)
            s = self._scan_cache.get(key)
            if s is None:
                s = [r_ * aw + c_ for c_ in range(aw) for r_ in range(ah)]
                self._scan_cache[key] = s
            return s
        return _SCANS[(aw, ah)]

    # ------------------------------------------------------------ prediction

    @staticmethod
    def _edge_strength(blk_wh, d, ftype):
        """aom intra_edge_filter_strength (spec 7.11.2.9 thresholds)."""
        if d == 0:
            return 0
        if ftype == 0:
            if blk_wh <= 8:
                return 1 if d >= 56 else 0
            if blk_wh <= 12:
                return 1 if d >= 40 else 0
            if blk_wh <= 16:
                return 1 if d >= 40 else 0
            if blk_wh <= 24:
                return 3 if d >= 32 else (2 if d >= 16 else (1 if d >= 8 else 0))
            if blk_wh <= 32:
                return 3 if d >= 32 else (2 if d >= 4 else 1)
            return 3
        if blk_wh <= 8:
            return 2 if d >= 64 else (1 if d >= 40 else 0)
        if blk_wh <= 16:
            return 2 if d >= 48 else (1 if d >= 20 else 0)
        if blk_wh <= 24:
            return 3 if d >= 4 else 0
        return 3

    @staticmethod
    def _filter_edge(p, sz, strength):
        """In-place 5-tap edge smoothing over p[1..sz-1] (p[0] = corner)."""
        if not strength or sz < 2:
            return
        kern = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))[strength - 1]
        edge = p[:sz].copy()
        for i in range(1, sz):
            s = 0
            for j in range(5):
                k = _clip3(0, sz - 1, i - 2 + j)
                s += int(edge[k]) * kern[j]
            p[i] = (s + 8) >> 4
    @staticmethod
    def _upsample_edge(vals, sz, corner):
        """-1,9,9,-1 half-pel upsample (aom av1_upsample_intra_edge):
        returns u with u[k+2] = edge at half-pel index k, k in
        [-2, 2*sz-2]; u[2i+2] = vals[i]."""
        fin = np.empty(sz + 3, np.int32)
        fin[0] = fin[1] = corner
        fin[2:sz + 2] = vals[:sz]
        fin[sz + 2] = vals[sz - 1]
        u = np.empty(2 * sz + 1, np.int32)
        u[0] = corner
        half = -fin[:sz] + 9 * fin[1:sz + 1] + 9 * fin[2:sz + 2] - fin[3:sz + 3]
        u[1::2] = np.clip((half + 8) >> 4, 0, 255)
        u[2::2] = fin[2:sz + 2]
        return u

    def _is_smooth(self, r, c, plane):
        if plane == 0:
            return int(self.y_mode[r, c]) in _SMOOTH_MODES
        m = int(self.uv_mode_g[r, c])
        return m in _SMOOTH_MODES

    def _predict(self, plane, x, y, w, h, ptx):
        arr = self.planes[plane]
        sx = self.ss_x if plane else 0
        sy = self.ss_y if plane else 0
        pmw = (self.mi_cols * 4) >> sx
        pmh = (self.mi_rows * 4) >> sy
        dec = self.decoded[plane]
        x4, y4, w4, h4 = x >> 2, y >> 2, w >> 2, h >> 2
        have_up = y > 0 and bool(dec[y4 - 1, x4])
        have_left = x > 0 and bool(dec[y4, x4 - 1])
        ur_ok = (
            y > 0 and x4 + w4 < dec.shape[1] and bool(dec[y4 - 1, x4 + w4])
        )
        bl_ok = (
            x > 0 and y4 + h4 < dec.shape[0] and bool(dec[y4 + h4, x4 - 1])
        )
        is_cfl = plane > 0 and self.b_uvmode == UV_CFL
        if is_cfl:
            mode, angle_d, fi = DC, 0, -1
        elif plane:
            mode, angle_d, fi = self.b_uvmode, self.b_angle_uv, -1
        else:
            mode, angle_d, fi = self.b_ymode, self.b_angle_y, self.b_filter_intra

        p_angle = MODE_ANGLE.get(mode, 0) + angle_d * 3
        need_right = mode == D45 or (p_angle and p_angle < 90) or mode == PAETH or fi >= 0
        need_bottom = (p_angle > 180) or mode == PAETH
        # above/left edges with offset 2 (room for corner & upsample)
        ew = 2 * (w + h) + 8
        ab = np.full(ew, 127, np.int32)
        le = np.full(ew, 129, np.int32)
        OFF = 2
        n_top = min(w, pmw - x) if have_up else 0
        n_left = min(h, pmh - y) if have_left else 0
        ntr = min(h, pmw - (x + w)) if (ur_ok and n_top == w) else 0
        nbl = min(w, pmh - (y + h)) if (bl_ok and n_left == h) else 0
        ntr = max(ntr, 0)
        nbl = max(nbl, 0)
        num_top = w + h
        num_left = w + h
        if n_top > 0:
            ab[OFF:OFF + n_top] = arr[y - 1, x:x + n_top]
            i = n_top
            if ntr > 0:
                ab[OFF + w:OFF + w + ntr] = arr[y - 1, x + w:x + w + ntr]
                i = w + ntr
            if i < num_top:
                ab[OFF + i:OFF + num_top] = ab[OFF + i - 1]
        elif n_left > 0:
            ab[OFF:OFF + num_top] = arr[y, x - 1]
        if n_left > 0:
            le[OFF:OFF + n_left] = arr[y:y + n_left, x - 1]
            i = n_left
            if nbl > 0:
                le[OFF + h:OFF + h + nbl] = arr[y + h:y + h + nbl, x - 1]
                i = h + nbl
            if i < num_left:
                le[OFF + i:OFF + num_left] = le[OFF + i - 1]
        elif n_top > 0:
            le[OFF:OFF + num_left] = arr[y - 1, x]
        # corner
        if n_top > 0 and n_left > 0:
            corner = int(arr[y - 1, x - 1])
        elif n_top > 0:
            corner = int(arr[y - 1, x])
        elif n_left > 0:
            corner = int(arr[y, x - 1])
        else:
            corner = 128
        ab[OFF - 1] = corner
        le[OFF - 1] = corner

        if fi >= 0:
            return self._pred_filter_intra(fi, ab[OFF:], le[OFF:], corner, w, h)
        if mode == DC or is_cfl:
            if have_up and have_left:
                dc = (int(ab[OFF:OFF + w].sum()) + int(le[OFF:OFF + h].sum()) + ((w + h) >> 1)) // (w + h)
            elif have_up:
                dc = (int(ab[OFF:OFF + w].sum()) + (w >> 1)) >> (w.bit_length() - 1)
            elif have_left:
                dc = (int(le[OFF:OFF + h].sum()) + (h >> 1)) >> (h.bit_length() - 1)
            else:
                dc = 128
            pred = np.full((h, w), dc, np.int32)
            if is_cfl:
                pred = self._cfl_adjust(pred, plane, x, y, w, h, sx, sy)
            return pred
        if mode == PAETH:
            a = ab[OFF:OFF + w][None, :]
            l_ = le[OFF:OFF + h][:, None]
            base = a + l_ - corner
            pa, pl, pc = np.abs(base - a), np.abs(base - l_), np.abs(base - corner)
            return np.where(
                (pa <= pl) & (pa <= pc), np.broadcast_to(a, (h, w)),
                np.where(pl <= pc, np.broadcast_to(l_, (h, w)), corner),
            ).astype(np.int32)
        if mode in (SMOOTH, SMOOTH_V, SMOOTH_H):
            wv = T.SM_WEIGHTS[_SMW_OFF[h]:_SMW_OFF[h] + h].astype(np.int64)[:, None]
            wh_ = T.SM_WEIGHTS[_SMW_OFF[w]:_SMW_OFF[w] + w].astype(np.int64)[None, :]
            a = ab[OFF:OFF + w].astype(np.int64)[None, :]
            l_ = le[OFF:OFF + h].astype(np.int64)[:, None]
            bl = int(le[OFF + h - 1])
            tr = int(ab[OFF + w - 1])
            if mode == SMOOTH:
                s = wv * a + (256 - wv) * bl + wh_ * l_ + (256 - wh_) * tr
                return ((s + 256) >> 9).astype(np.int32)
            if mode == SMOOTH_V:
                s = wv * a + (256 - wv) * bl
            else:
                s = wh_ * l_ + (256 - wh_) * tr
            return ((s + 128) >> 8).astype(np.int32)
        if mode == V and p_angle == 90:
            return np.broadcast_to(ab[OFF:OFF + w], (h, w)).astype(np.int32).copy()
        if mode == H and p_angle == 180:
            return np.broadcast_to(le[OFF:OFF + h][:, None], (h, w)).astype(np.int32).copy()
        return self._pred_directional(
            plane, p_angle, ab, le, OFF, w, h, n_top, n_left, ntr, nbl,
            have_up and n_top > 0, have_left and n_left > 0,
        )

    def _filt_type(self, plane):
        r, c = self.b_r, self.b_c
        ab = self._is_smooth(r - 1, c, plane) if r > 0 else False
        le = self._is_smooth(r, c - 1, plane) if c > 0 else False
        return 1 if (ab or le) else 0

    def _pred_directional(
        self, plane, p_angle, ab, le, OFF, w, h,
        n_top, n_left, ntr, nbl, have_up, have_left,
    ):
        ups_a = ups_l = 0
        if self.seq.enable_intra_edge_filter:
            if 90 < p_angle < 180 and (w + h) >= 24:
                s = (int(le[OFF]) * 5 + int(ab[OFF - 1]) * 6 + int(ab[OFF]) * 5 + 8) >> 4
                ab[OFF - 1] = s
                le[OFF - 1] = s
            filt = self._filt_type(plane)
            if p_angle != 90 and p_angle != 180:
                if have_up:
                    st = self._edge_strength(w + h, abs(p_angle - 90), filt)
                    sz = n_top + 1 + (h if p_angle < 90 else 0)
                    self._filter_edge(ab[OFF - 1:], sz, st)
                if have_left:
                    st = self._edge_strength(w + h, abs(p_angle - 180), filt)
                    sz = n_left + 1 + (w if p_angle > 180 else 0)
                    self._filter_edge(le[OFF - 1:], sz, st)
            d_a, d_l = abs(p_angle - 90), abs(p_angle - 180)
            lim = 16 if filt == 0 else 8
            ups_a = int(0 < d_a < 40 and (w + h) <= lim)
            ups_l = int(0 < d_l < 40 and (w + h) <= lim)
        # final edge arrays with origin index A_OFF (supports index -2)
        if ups_a:
            n = w + (h if p_angle < 90 else 0)
            A = self._upsample_edge(ab[OFF:], n, int(ab[OFF - 1]))
            A_OFF = 2
        else:
            A, A_OFF = ab, OFF
        if ups_l:
            n = h + (w if p_angle > 180 else 0)
            L_ = self._upsample_edge(le[OFF:], n, int(le[OFF - 1]))
            L_OFF = 2
        else:
            L_, L_OFF = le, OFF

        DR = T.DR_INTRA_DERIVATIVE
        out = np.empty((h, w), np.int32)
        cs = np.arange(w)
        if p_angle < 90:  # zone 1: above only
            dx = int(DR[p_angle])
            fb = 6 - ups_a
            max_base = (w + h - 1) << ups_a
            maxv = int(A[A_OFF + max_base])
            for r in range(h):
                xpos = dx * (r + 1)
                base = (xpos >> fb) + (cs << ups_a)
                sh = ((xpos << ups_a) & 63) >> 1
                b = np.minimum(base, max_base)
                v = (A[A_OFF + b] * (32 - sh) + A[A_OFF + np.minimum(b + 1, max_base)] * sh + 16) >> 5
                out[r] = np.where(base >= max_base, maxv, v)
        elif p_angle > 180:  # zone 3: left only
            dy = int(DR[270 - p_angle])
            fb = 6 - ups_l
            max_base = (w + h - 1) << ups_l
            maxv = int(L_[L_OFF + max_base])
            rs = np.arange(h)
            for c in range(w):
                ypos = dy * (c + 1)
                base = (ypos >> fb) + (rs << ups_l)
                sh = ((ypos << ups_l) & 63) >> 1
                b = np.minimum(base, max_base)
                v = (L_[L_OFF + b] * (32 - sh) + L_[L_OFF + np.minimum(b + 1, max_base)] * sh + 16) >> 5
                out[:, c] = np.where(base >= max_base, maxv, v)
        else:  # zone 2: both edges
            dx = int(DR[180 - p_angle])
            dy = int(DR[p_angle - 90])
            fbx, fby = 6 - ups_a, 6 - ups_l
            min_base_x = -(1 << ups_a)
            for r in range(h):
                xv = (cs << 6) - (r + 1) * dx
                base_x = xv >> fbx
                shx = ((xv << ups_a) & 63) >> 1
                bx = np.maximum(base_x, min_base_x)
                va = (A[A_OFF + bx] * (32 - shx) + A[A_OFF + bx + 1] * shx + 16) >> 5
                yv = (r << 6) - (cs + 1) * dy
                base_y = yv >> fby
                shy = ((yv << ups_l) & 63) >> 1
                by = np.maximum(base_y, -(1 << ups_l))
                vl = (L_[L_OFF + by] * (32 - shy) + L_[L_OFF + by + 1] * shy + 16) >> 5
                out[r] = np.where(base_x >= min_base_x, va, vl)
        return out

    def _pred_filter_intra(self, fi, abv, lft, corner, w, h):
        taps = T.FILTER_INTRA_TAPS[fi].astype(np.int32)
        buf = np.zeros((h + 1, w + 1), np.int32)
        buf[0, 0] = corner
        buf[0, 1:] = abv[:w]
        buf[1:, 0] = lft[:h]
        for r in range(0, h, 2):
            for c in range(1, w + 1, 4):
                p = (
                    int(buf[r, c - 1]),
                    int(buf[r, c]), int(buf[r, c + 1]),
                    int(buf[r, c + 2]), int(buf[r, c + 3]),
                    int(buf[r + 1, c - 1]), int(buf[r + 2, c - 1]),
                )
                for k in range(8):
                    s = 0
                    tk = taps[k]
                    for j in range(7):
                        s += int(tk[j]) * p[j]
                    v = (s + 8) >> 4 if s >= 0 else -((-s + 8) >> 4)
                    buf[r + 1 + (k >> 2), c + (k & 3)] = _clip3(0, 255, v)
        return buf[1:, 1:]

    def _cfl_adjust(self, pred, plane, x, y, w, h, sx, sy):
        lum = self.planes[0][y << sy:(y + h) << sy, x << sx:(x + w) << sx]
        if sx and sy:
            sub = (lum[0::2, 0::2] + lum[0::2, 1::2] + lum[1::2, 0::2] + lum[1::2, 1::2]) << 1
        elif sx:
            sub = (lum[:, 0::2] + lum[:, 1::2]) << 2
        else:
            sub = lum << 3
        npl = (w * h).bit_length() - 1
        avg = (int(sub.sum()) + (1 << (npl - 1))) >> npl
        ac = sub.astype(np.int64) - avg
        alpha = self.b_cfl_alpha_u if plane == 1 else self.b_cfl_alpha_v
        sc = alpha * ac
        d = np.where(sc >= 0, (sc + 32) >> 6, -((-sc + 32) >> 6))
        return np.clip(pred + d, 0, 255).astype(np.int32)


def decode_frame(
    seq: SequenceHeader, hdr: FrameHeader, tile_data: bytes,
    apply_deblock: bool = True, apply_cdef: bool = True,
):
    """Decode one still AV1 frame -> list of uint8 planes (Y[,U,V]),
    cropped to hdr.width/height (chroma per subsampling)."""
    if hdr.tile_cols != 1 or hdr.tile_rows != 1:
        raise ValueError("AV1 multi-tile still pictures are out of scope")
    td = TileDecoder(seq, hdr, tile_data)
    planes = td.decode()
    if apply_deblock and any(hdr.loop_filter_level):
        _deblock(td)
    if apply_cdef and seq.enable_cdef and not hdr.coded_lossless:
        if any(td.hdr.cdef_y_pri) or any(td.hdr.cdef_y_sec) or any(
            td.hdr.cdef_uv_pri
        ) or any(td.hdr.cdef_uv_sec):
            _cdef(td)
    out = []
    for p, arr in enumerate(planes):
        sx = td.ss_x if p else 0
        sy = td.ss_y if p else 0
        w = (hdr.width + (1 << sx) - 1) >> sx
        h = (hdr.height + (1 << sy) - 1) >> sy
        out.append(arr[:h, :w].astype(np.uint8))
    return out


# ------------------------------------------------------------ deblocking
#
# Spec 7.14, intra/still profile: no segmentation, no delta-lf, every
# block references INTRA_FRAME, so the filter level is uniform per
# (plane, direction).  Each pass is vectorised one edge-column at a
# time over every pixel row crossing it (the horizontal pass runs the
# same code on transposed views).  Pinned plane-exact vs dav1d
# INLOOP_DEBLOCK (tests/test_torch_codecs_avif.py).


def _lf_level(base, ref_delta):
    if base == 0:
        return 0
    return _clip3(0, 63, base + ref_delta * (1 << (base >> 5)))


def _deblock(td):
    hdr = td.hdr
    ref_d = (
        hdr.loop_filter_ref_deltas[0]
        if hdr.loop_filter_delta_enabled
        else 0
    )
    sharp = hdr.loop_filter_sharpness
    for plane in range(td.nplanes):
        for horz in (0, 1):
            base = hdr.loop_filter_level[horz if plane == 0 else 1 + plane]
            lvl = _lf_level(base, ref_d)
            if lvl:
                _deblock_pass(td, plane, horz, lvl, sharp)


def _deblock_pass(td, plane, horz, lvl, sharp):
    sx = td.ss_x if plane else 0
    sy = td.ss_y if plane else 0
    arr = td.planes[plane]
    if plane == 0:
        txw, txh = td.tx_w4, td.tx_h4
    else:
        txw, txh = td.tx_uv_w4, td.tx_uv_h4
    skip = td.skip_g
    blk_e = td.blk_left if not horz else td.blk_top
    txe = td.txe_l[min(plane, 1)] if not horz else td.txe_t[min(plane, 1)]
    # dav1d/aom bound the filtered area by the CROPPED plane rounded up
    # to 4 (f->h4/w4), not the mi grid: an overhang H-edge would write
    # visible rows, and the unfiltered overhang feeds CDEF's direction
    # search, so this is observable in the visible output.
    crop_w = (td.hdr.width + (1 << sx) - 1) >> sx
    crop_h = (td.hdr.height + (1 << sy) - 1) >> sy
    vis_w = ((crop_w + 3) >> 2) << 2
    vis_h = ((crop_h + 3) >> 2) << 2
    if horz:
        arr = arr.T
        txw, txh = txh.T, txw.T
        skip = skip.T
        blk_e = blk_e.T
        txe = txe.T
        vis_w, vis_h = vis_h, vis_w
        sx, sy = sy, sx

    # limits (spec 7.14.5)
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    limit = _clip3(1, 9 - sharp, lvl >> shift) if sharp > 0 else max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4

    n_units = -(-vis_h // 4)
    urow = np.arange(vis_h) >> 2
    u = np.arange(n_units)
    mi_r = u << sy
    cap = 4 if plane == 0 else 2  # luma 16px / chroma 8px in 4px units
    for x in range(4, vis_w, 4):
        uc = x >> 2
        mi_c = uc << sx
        cw, pw = txw[u, uc], txw[u, uc - 1]
        is_be = blk_e[mi_r, mi_c].astype(bool)
        s_cur = skip[mi_r, mi_c].astype(bool)
        s_prv = skip[mi_r, mi_c - (1 << sx)].astype(bool)
        on_u = txe[u, uc].astype(bool) & (is_be | ~(s_cur & s_prv))
        if not on_u.any():
            continue
        wd_u = np.minimum(np.minimum(cw, pw), cap) * 4
        if plane:
            wd_u = np.where(wd_u == 8, 6, wd_u)
        on = on_u[urow]
        wd = wd_u[urow]
        idx = np.clip(x + np.arange(-7, 7), 0, arr.shape[1] - 1)
        win = arr[:vis_h, idx].astype(np.int32)  # p6..p0 q0..q6
        p = {i: win[:, 6 - i] for i in range(7)}
        q = {i: win[:, 7 + i] for i in range(7)}
        for off, vals, mask in _lf_filter(p, q, wd, on, limit, blimit, thresh):
            np.copyto(arr[:vis_h, x + off], vals, where=mask)


def _lf_filter(p, q, wd, on, limit, blimit, thresh):
    """Vectorised spec 7.14.6 along one edge: p/q map tap index to the
    pixel columns, wd is the per-row filter width (4, 6 chroma-wide,
    8, 16), on the per-row edge-enable.  Returns [(offset, values,
    mask)] updates with offsets relative to the edge (-1 = p0, 0 = q0).
    """
    ab = lambda a, b: np.abs(a - b)  # noqa: E731
    fm = (
        (ab(p[1], p[0]) <= limit)
        & (ab(q[1], q[0]) <= limit)
        & (ab(p[0], q[0]) * 2 + (ab(p[1], q[1]) >> 1) <= blimit)
    )
    fm6 = fm & (ab(p[2], p[1]) <= limit) & (ab(q[2], q[1]) <= limit)
    fm8 = fm6 & (ab(p[3], p[2]) <= limit) & (ab(q[3], q[2]) <= limit)
    fmw = np.select([wd == 4, wd == 6], [fm, fm6], fm8) & on
    flat_in = (
        (ab(p[2], p[0]) <= 1)
        & (ab(p[1], p[0]) <= 1)
        & (ab(q[1], q[0]) <= 1)
        & (ab(q[2], q[0]) <= 1)
    )
    flat8 = flat_in & (ab(p[3], p[0]) <= 1) & (ab(q[3], q[0]) <= 1)
    flat_out = (
        (ab(p[6], p[0]) <= 1)
        & (ab(p[5], p[0]) <= 1)
        & (ab(p[4], p[0]) <= 1)
        & (ab(q[4], q[0]) <= 1)
        & (ab(q[5], q[0]) <= 1)
        & (ab(q[6], q[0]) <= 1)
    )
    m14 = fmw & (wd == 16) & flat8 & flat_out
    m8 = fmw & (((wd == 16) & flat8 & ~flat_out) | ((wd == 8) & flat8))
    m6 = fmw & (wd == 6) & flat_in
    m4 = fmw & ~m14 & ~m8 & ~m6
    out = []
    r3 = lambda s: (s + 4) >> 3  # noqa: E731
    r4_ = lambda s: (s + 8) >> 4  # noqa: E731
    P, Q = p, q
    if m14.any():
        out += [
            (-6, r4_(P[6] * 7 + P[5] * 2 + P[4] * 2 + P[3] + P[2] + P[1] + P[0] + Q[0]), m14),
            (-5, r4_(P[6] * 5 + P[5] * 2 + P[4] * 2 + P[3] * 2 + P[2] + P[1] + P[0] + Q[0] + Q[1]), m14),
            (-4, r4_(P[6] * 4 + P[5] + P[4] * 2 + P[3] * 2 + P[2] * 2 + P[1] + P[0] + Q[0] + Q[1] + Q[2]), m14),
            (-3, r4_(P[6] * 3 + P[5] + P[4] + P[3] * 2 + P[2] * 2 + P[1] * 2 + P[0] + Q[0] + Q[1] + Q[2] + Q[3]), m14),
            (-2, r4_(P[6] * 2 + P[5] + P[4] + P[3] + P[2] * 2 + P[1] * 2 + P[0] * 2 + Q[0] + Q[1] + Q[2] + Q[3] + Q[4]), m14),
            (-1, r4_(P[6] + P[5] + P[4] + P[3] + P[2] + P[1] * 2 + P[0] * 2 + Q[0] * 2 + Q[1] + Q[2] + Q[3] + Q[4] + Q[5]), m14),
            (0, r4_(P[5] + P[4] + P[3] + P[2] + P[1] + P[0] * 2 + Q[0] * 2 + Q[1] * 2 + Q[2] + Q[3] + Q[4] + Q[5] + Q[6]), m14),
            (1, r4_(P[4] + P[3] + P[2] + P[1] + P[0] + Q[0] * 2 + Q[1] * 2 + Q[2] * 2 + Q[3] + Q[4] + Q[5] + Q[6] * 2), m14),
            (2, r4_(P[3] + P[2] + P[1] + P[0] + Q[0] + Q[1] * 2 + Q[2] * 2 + Q[3] * 2 + Q[4] + Q[5] + Q[6] * 3), m14),
            (3, r4_(P[2] + P[1] + P[0] + Q[0] + Q[1] + Q[2] * 2 + Q[3] * 2 + Q[4] * 2 + Q[5] + Q[6] * 4), m14),
            (4, r4_(P[1] + P[0] + Q[0] + Q[1] + Q[2] + Q[3] * 2 + Q[4] * 2 + Q[5] * 2 + Q[6] * 5), m14),
            (5, r4_(P[0] + Q[0] + Q[1] + Q[2] + Q[3] + Q[4] * 2 + Q[5] * 2 + Q[6] * 7), m14),
        ]
    if m8.any():
        out += [
            (-3, r3(P[3] + P[3] + P[3] + 2 * P[2] + P[1] + P[0] + Q[0]), m8),
            (-2, r3(P[3] + P[3] + P[2] + 2 * P[1] + P[0] + Q[0] + Q[1]), m8),
            (-1, r3(P[3] + P[2] + P[1] + 2 * P[0] + Q[0] + Q[1] + Q[2]), m8),
            (0, r3(P[2] + P[1] + P[0] + 2 * Q[0] + Q[1] + Q[2] + Q[3]), m8),
            (1, r3(P[1] + P[0] + Q[0] + 2 * Q[1] + Q[2] + Q[3] + Q[3]), m8),
            (2, r3(P[0] + Q[0] + Q[1] + 2 * Q[2] + Q[3] + Q[3] + Q[3]), m8),
        ]
    if m6.any():
        out += [
            (-2, r3(P[2] * 3 + P[1] * 2 + P[0] * 2 + Q[0]), m6),
            (-1, r3(P[2] + P[1] * 2 + P[0] * 2 + Q[0] * 2 + Q[1]), m6),
            (0, r3(P[1] + P[0] * 2 + Q[0] * 2 + Q[1] * 2 + Q[2]), m6),
            (1, r3(P[0] + Q[0] * 2 + Q[1] * 2 + Q[2] * 3), m6),
        ]
    if m4.any():
        hev = (np.abs(p[1] - p[0]) > thresh) | (np.abs(q[1] - q[0]) > thresh)
        c8 = lambda v: np.clip(v, -128, 127)  # noqa: E731
        ps1, ps0 = p[1] - 128, p[0] - 128
        qs0, qs1 = q[0] - 128, q[1] - 128
        f = np.where(hev, c8(ps1 - qs1), 0)
        f = c8(f + 3 * (qs0 - ps0))
        f1 = c8(f + 4) >> 3
        f2 = c8(f + 3) >> 3
        out.append((-1, np.clip(c8(ps0 + f2) + 128, 0, 255), m4))
        out.append((0, np.clip(c8(qs0 - f1) + 128, 0, 255), m4))
        f3 = (f1 + 1) >> 1
        m4n = m4 & ~hev
        out.append((-2, np.clip(c8(ps1 + f3) + 128, 0, 255), m4n))
        out.append((1, np.clip(c8(qs1 - f3) + 128, 0, 255), m4n))
    return out


# ----------------------------------------------------------------- CDEF
#
# Spec 7.15: per 8x8 luma block, direction search on the deblocked
# frame, then the constrained directional filter with primary taps
# along the detected direction and secondary taps at +-2 directions.
# Reads come from a VERY_LARGE-padded copy so filtering never cascades.

_CDEF_DIV = [0, 840, 420, 280, 210, 168, 140, 120, 105]
# direction offsets (dy, dx) for the two primary taps of each of the 8
# directions (spec 7.15.3 Cdef_Directions)
_CDEF_DIRS = [
    [(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
    [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
    [(1, 0), (2, 0)], [(1, 0), (2, -1)],
]
# spec 7.15.1 Cdef_Uv_Dir: the chroma direction for each luma direction
# when chroma is subsampled along one axis only; 4:2:0 and 4:4:4 keep it
_CDEF_UV_DIR_SS_X_ONLY = [7, 0, 2, 4, 5, 6, 6, 6]  # 4:2:2
_CDEF_UV_DIR_SS_Y_ONLY = [1, 2, 2, 2, 3, 4, 6, 0]  # 4:4:0


def _cdef_uv_direction(dir_: int, ss_x: int, ss_y: int) -> int:
    if ss_x and not ss_y:
        return _CDEF_UV_DIR_SS_X_ONLY[dir_]
    if ss_y and not ss_x:
        return _CDEF_UV_DIR_SS_Y_ONLY[dir_]
    return dir_
_CDEF_LARGE = 30000


def _cdef_dir_mats():
    """(64, 15) one-hot scatter matrices, one per direction (cached)."""
    global _CDEF_DIR_MATS
    try:
        return _CDEF_DIR_MATS
    except NameError:
        pass
    i, j = np.mgrid[0:8, 0:8]
    bins = [
        i + j, i + (j >> 1), i, 3 + i - (j >> 1), 7 + i - j,
        3 - (i >> 1) + j, j, (i >> 1) + j,
    ]
    mats = []
    for b in bins:
        m = np.zeros((64, 15), np.int64)
        m[np.arange(64), b.ravel()] = 1
        mats.append(m)
    _CDEF_DIR_MATS = mats
    return mats


def _cdef_dirs_batch(blocks):
    """Spec 7.15.2 over N stacked 8x8 luma blocks -> (dirs, vars)."""
    x = blocks.reshape(-1, 64).astype(np.int64) - 128
    mats = _cdef_dir_mats()
    n = x.shape[0]
    cost = np.zeros((n, 8), np.int64)
    div = np.asarray(_CDEF_DIV, np.int64)
    for d in range(8):
        p = x @ mats[d]  # (n, 15) partial sums
        p2 = p * p
        if d in (2, 6):
            cost[:, d] = 105 * p2[:, :8].sum(1)
        elif d in (0, 4):
            w = np.empty(15, np.int64)
            for k in range(7):
                w[k] = div[k + 1]
                w[14 - k] = div[k + 1]
            w[7] = div[8]
            cost[:, d] = p2 @ w
        else:
            w = np.zeros(15, np.int64)
            w[3:8] = 105
            for k in range(3):
                w[k] = div[2 * k + 2]
                w[10 - k] = div[2 * k + 2]
            cost[:, d] = p2[:, :11] @ w[:11]
    best = cost.argmax(1)
    var = (cost[np.arange(n), best] - cost[np.arange(n), (best + 4) & 7]) >> 10
    return best.astype(np.int64), var


def _cdef_dir(block):
    """Spec 7.15.2: direction + variance of one 8x8 luma block."""
    dirs, variances = _cdef_dirs_batch(block[None])
    return int(dirs[0]), int(variances[0])


def _constrain(diff, strength, damping):
    if not strength:
        return np.zeros_like(diff)
    shift = max(0, damping - (strength.bit_length() - 1))
    ad = np.abs(diff)
    return np.sign(diff) * np.minimum(
        ad, np.maximum(0, strength - (ad >> shift))
    )


def _cdef_block(src, y0, x0, h, w, dir_, pri, sec, damping):
    """Filter one block against the padded source; returns the output."""
    x = src[y0:y0 + h, x0:x0 + w].astype(np.int32)
    sum_ = np.zeros_like(x)
    mx = x.copy()
    mn = x.copy()
    pri_taps = (3, 3) if pri & 1 else (4, 2)
    sec_taps = (2, 1)

    def tap(dy, dx):
        return src[y0 + dy:y0 + dy + h, x0 + dx:x0 + dx + w].astype(np.int32)

    for k in range(2):
        if pri:
            dy, dx = _CDEF_DIRS[dir_][k]
            for s in (1, -1):
                pv = tap(s * dy, s * dx)
                sum_ += pri_taps[k] * _constrain(pv - x, pri, damping)
                mx = np.maximum(mx, np.where(pv == _CDEF_LARGE, mx, pv))
                mn = np.minimum(mn, pv)
        if sec:
            for dd in ((dir_ + 2) & 7, (dir_ + 6) & 7):
                dy, dx = _CDEF_DIRS[dd][k]
                for s in (1, -1):
                    pv = tap(s * dy, s * dx)
                    sum_ += sec_taps[k] * _constrain(pv - x, sec, damping)
                    mx = np.maximum(mx, np.where(pv == _CDEF_LARGE, mx, pv))
                    mn = np.minimum(mn, pv)
    y = x + ((8 + sum_ - (sum_ < 0)) >> 4)
    return np.clip(y, mn, mx)


def _cdef(td):
    hdr = td.hdr
    mi_r, mi_c = td.mi_rows, td.mi_cols
    fh, fw = mi_r * 4, mi_c * 4
    pad = 8
    srcs = []
    for p in range(td.nplanes):
        sx = td.ss_x if p else 0
        sy = td.ss_y if p else 0
        ph = -(-fh // (1 << sy))
        pw = -(-fw // (1 << sx))
        s = np.full((ph + 2 * pad, pw + 2 * pad), _CDEF_LARGE, np.int32)
        s[pad:pad + ph, pad:pad + pw] = td.planes[p][:ph, :pw]
        srcs.append(s)
    damping = hdr.cdef_damping
    # pass 1: collect candidate blocks, then one batched direction search
    cands = []
    for r in range(0, mi_r, 2):
        for c in range(0, mi_c, 2):
            r1 = min(r + 1, mi_r - 1)
            c1 = min(c + 1, mi_c - 1)
            if (
                td.skip_g[r, c] and td.skip_g[r1, c] and td.skip_g[r, c1]
                and td.skip_g[r1, c1]
            ):
                continue
            idx = int(td.cdef_idx[r >> 4, c >> 4])
            if idx < 0:
                idx = 0
            y_pri = hdr.cdef_y_pri[idx]
            y_sec = hdr.cdef_y_sec[idx]
            uv_pri = hdr.cdef_uv_pri[idx] if td.nplanes > 1 else 0
            uv_sec = hdr.cdef_uv_sec[idx] if td.nplanes > 1 else 0
            if not (y_pri or y_sec or uv_pri or uv_sec):
                continue
            cands.append((r, c, y_pri, y_sec, uv_pri, uv_sec))
    if not cands:
        return
    blocks = np.stack([
        np.where(
            srcs[0][pad + r * 4:pad + r * 4 + 8, pad + c * 4:pad + c * 4 + 8]
            == _CDEF_LARGE,
            0,
            srcs[0][pad + r * 4:pad + r * 4 + 8, pad + c * 4:pad + c * 4 + 8],
        )
        for (r, c, *_rest) in cands
    ])
    dirs, variances = _cdef_dirs_batch(blocks)
    for bi, (r, c, y_pri, y_sec, uv_pri, uv_sec) in enumerate(cands):
        y0, x0 = r * 4, c * 4
        h = min(8, fh - y0)
        w = min(8, fw - x0)
        dir_, var = int(dirs[bi]), int(variances[bi])
        if y_pri or y_sec:
            pri = y_pri
            if pri:
                i = min((var >> 6).bit_length() - 1, 12) if (var >> 6) else 0
                pri = (pri * (4 + i) + 8) >> 4 if var else 0
            out = _cdef_block(
                srcs[0], pad + y0, pad + x0, h, w, dir_, pri, y_sec,
                damping,
            )
            td.planes[0][y0:y0 + h, x0:x0 + w] = out
        if (uv_pri or uv_sec) and td.nplanes > 1:
            sx, sy = td.ss_x, td.ss_y
            cy, cx_ = y0 >> sy, x0 >> sx
            ch = min(8 >> sy, (-(-fh // (1 << sy))) - cy)
            cw = min(8 >> sx, (-(-fw // (1 << sx))) - cx_)
            cdir = _cdef_uv_direction(dir_, sx, sy)
            for p in (1, 2):
                out = _cdef_block(
                    srcs[p], pad + cy, pad + cx_, ch, cw, cdir,
                    uv_pri, uv_sec, damping - 1,
                )
                td.planes[p][cy:cy + ch, cx_:cx_ + cw] = out
