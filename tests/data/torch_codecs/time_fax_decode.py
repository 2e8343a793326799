"""Times the CCITT fax decode of the JAX package (utils/fax.py) and of the
port (host/fax.py) on the same TIFFs: a side x side frame of random
bilevel noise (half black) written by PIL as G3, G4 and MH, each decoded
once through decode_tiff on the host clock, the two outputs held equal.
The port's 2D rows resume their b1 search where the last one ended, a
change of speed only: G4 shows it, G3 (1D rows here) and MH do not.

    python tests/data/torch_codecs/time_fax_decode.py [--sizes 512 2048]
"""

import argparse
import io
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))  # the repo root

from fft_restoration_tpu.utils import formats as jf  # noqa: E402
from fft_restoration_tpu_torch.host import formats as pf  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 2048])
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    for n in args.sizes:
        bw = rng.random((n, n)) < 0.5
        for comp in ("group3", "group4", "tiff_ccitt"):
            buf = io.BytesIO()
            Image.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
                buf, format="TIFF", compression=comp)
            blob = buf.getvalue()
            t0 = time.perf_counter()
            want = jf.decode_tiff(blob)
            t_jax = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = pf.decode_tiff(blob)
            t_port = time.perf_counter() - t0
            assert np.array_equal(got, want)
            print(f"{n}x{n} {comp}: JAX {t_jax:.3f} s, port {t_port:.3f} s", flush=True)


if __name__ == "__main__":
    main()
