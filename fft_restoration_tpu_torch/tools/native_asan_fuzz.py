"""AddressSanitizer replay of the native codec fuzz corpus.

    python -m fft_restoration_tpu_torch.tools.native_asan_fuzz

The port's counterpart of the JAX package's tools/native_asan_fuzz.py.
tests/test_torch_codecs_native_fuzz.py shows that the C++ decoders of
csrc/host/ survive corrupt payloads with their sentinel bytes untouched;
under ASAN instrumentation the same corpus also catches the heap
overflows, uses after free and out-of-bounds reads that a sentinel arena
cannot see. It is a one-shot check, not a test: ASAN's runtime must be
preloaded before the interpreter starts, so the corpus runs in a child
interpreter with LD_PRELOAD set to libasan and then libstdc++ (libstdc++
must be resident when ASAN initializes, or its __cxa_throw interceptor
stays null and the decoders' first throw aborts the process).

The child sets host/native.py's CXX_FLAGS to `-O1 -g -fPIC -shared
-fsanitize=address` and its BUILD_ROOT to a temporary directory before
pytest imports the codecs, so every library the corpus loads is built
instrumented there (the build directory's hash covers the flags) and
nothing lands in the checkout's build/. ASAN's reports go to files in
the same directory and are printed. Exit code 0: the whole corpus ran
clean; 2: g++ has no libasan.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CORPUS = (REPO / "tests" / "test_torch_codecs_native_fuzz.py",)
ASAN_FLAGS = ("-O1", "-g", "-fPIC", "-shared", "-fsanitize=address")

_CHILD = """\
import sys
from pathlib import Path

import pytest

from fft_restoration_tpu_torch.host import native

native.CXX_FLAGS = {flags!r}
native.BUILD_ROOT = Path({root!r})
sys.exit(pytest.main({args!r}))
"""


def _gcc_file(name: str) -> str:
    return subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True,
                          text=True).stdout.strip()


def child_command(tmp: str, asan_rt: str, stdcxx: str) -> tuple:
    """(argv, env) of the child interpreter that replays the corpus on
    libraries built with ASAN_FLAGS under `tmp`."""
    args = [str(p) for p in CORPUS] + ["-q", "-p", "no:cacheprovider", "--noconftest"]
    code = _CHILD.format(flags=ASAN_FLAGS, root=str(Path(tmp) / "native"), args=args)
    env = dict(os.environ)
    env.update(
        LD_PRELOAD=f"{asan_rt} {stdcxx}",
        PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")])),
        # the interpreter's deliberate leaks would trip LeakSanitizer; the
        # target is the codecs
        ASAN_OPTIONS=("detect_leaks=0:allocator_may_return_null=0:"
                      f"log_path={Path(tmp) / 'asan_report'}"),
    )
    return [sys.executable, "-c", code], env


def main() -> int:
    asan_rt = _gcc_file("libasan.so")
    if not asan_rt or not Path(asan_rt).is_file():
        print("g++ has no libasan.so; nothing to do", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="fft_torch_asan_") as tmp:
        argv, env = child_command(tmp, asan_rt, _gcc_file("libstdc++.so.6"))
        print(f"+ LD_PRELOAD={env['LD_PRELOAD']!r} {' '.join(map(str, CORPUS))}", flush=True)
        rc = subprocess.run(argv, env=env, cwd=str(REPO)).returncode
        reports = sorted(Path(tmp).glob("asan_report*"))
        for report in reports:
            print(report.read_text(errors="replace"))
        clean = rc == 0 and not reports
        print(f"ASAN fuzz replay: {'CLEAN' if clean else f'FAILED rc={rc}, {len(reports)} report(s)'}")
        return 0 if clean else (rc or 1)


if __name__ == "__main__":
    sys.exit(main())
