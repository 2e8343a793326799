"""AV1 multi-symbol adaptive arithmetic decoder (spec 8.2, "MSAC"): the
port's copy of the JAX package's utils/av1_msac.py.

From-scratch implementation of the Daala-derived range coder the AV1
still-picture decoder (av1_decode.py) reads every symbol through.  The
arithmetic follows the spec's decode process exactly in the 64-bit
window formulation: the window holds the ones'-complement of the
bitstream (bytes are XORed into an all-ones register), the range lives
in [2^15, 2^16), and CDFs are stored inverted ("probability of symbol
>= i+1", 15-bit scale) exactly as the default tables in _av1_tables.py
are laid out: n-1 strictly decreasing entries, a 0 terminator, then the
adaptation counter.
"""

from __future__ import annotations

__all__ = ["Msac"]

_MASK64 = (1 << 64) - 1
_EC_PROB_SHIFT = 6
_EC_MIN_PROB = 4


class Msac:
    __slots__ = ("buf", "pos", "end", "dif", "rng", "cnt", "update")

    def __init__(self, data: bytes, allow_update_cdf: bool = True):
        self.buf = data
        self.pos = 0
        self.end = len(data)
        self.dif = (1 << 63) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.update = allow_update_cdf
        self._refill()

    # ------------------------------------------------------------ internals

    def _refill(self):
        c = 64 - self.cnt - 24
        dif = self.dif
        pos, end, buf = self.pos, self.end, self.buf
        while c >= 0 and pos < end:
            dif ^= buf[pos] << c
            pos += 1
            c -= 8
        self.dif = dif
        self.cnt = 64 - c - 24
        self.pos = pos

    def _norm(self, dif: int, rng: int):
        d = 15 - (rng.bit_length() - 1)
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _MASK64
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    # -------------------------------------------------------------- symbols

    def symbol(self, cdf, n_symbols: int) -> int:
        """Decode one symbol against an inverted CDF and adapt it.

        `cdf` is a mutable sequence of n_symbols+1 uint16 slots
        (n_symbols-1 probabilities, 0, counter).
        """
        c = self.dif >> 48
        r = self.rng >> 8
        u = self.rng
        v = self.rng
        val = -1
        while True:
            val += 1
            u = v
            v = r * (cdf[val] >> _EC_PROB_SHIFT)
            v >>= 7 - _EC_PROB_SHIFT
            v += _EC_MIN_PROB * (n_symbols - val - 1)
            if c >= v:
                break
        self._norm(self.dif - (v << 48), u - v)
        if self.update:
            count = cdf[n_symbols]
            rate = 4 + (count >> 4) + (1 if n_symbols > 3 else 0)
            for i in range(val):
                cdf[i] += (32768 - cdf[i]) >> rate
            for i in range(val, n_symbols - 1):
                cdf[i] -= cdf[i] >> rate
            cdf[n_symbols] = count + (1 if count < 32 else 0)
        return val

    def bool_cdf(self, cdf) -> int:
        """Adaptive boolean: cdf is [prob, counter] (2 slots)."""
        bit = self.bool_prob(cdf[0])
        if self.update:
            count = cdf[1]
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] += (32768 - cdf[0]) >> rate
            else:
                cdf[0] -= cdf[0] >> rate
            cdf[1] = count + (1 if count < 32 else 0)
        return bit

    def bool_prob(self, f: int) -> int:
        """Non-adaptive boolean with 15-bit inverted probability f.

        Returns 1 when the coded value is past f (dav1d's !ret), i.e.
        f is the inverted-CDF entry for "symbol 0".
        """
        r = self.rng
        v = ((r >> 8) * (f >> _EC_PROB_SHIFT) >> (7 - _EC_PROB_SHIFT)) + (
            _EC_MIN_PROB
        )
        vw = v << 48
        if self.dif >= vw:
            ret = 0
            dif = self.dif - vw
            rng = r - v
        else:
            ret = 1
            dif = self.dif
            rng = v
        self._norm(dif, rng)
        return ret

    def bool_equi(self) -> int:
        return self.bool_prob(1 << 14)

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bool_equi()
        return v

    def golomb(self) -> int:
        """Exp-Golomb suffix used past the coeff_br range (spec 9.3 /
        read_golomb)."""
        length = 0
        while not self.bool_equi():
            length += 1
            if length > 31:
                raise ValueError("corrupt AV1: runaway golomb prefix")
        x = 1
        for _ in range(length):
            x = (x << 1) | self.bool_equi()
        return x - 1
