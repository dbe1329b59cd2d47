"""PyTorch port, the kernel build (``emcid_torch/ops/_build.py``) under
processes that start together against a cold build directory, as the
ranks of ``torchrun`` do.  A stub ``nvcc`` on ``PATH`` writes its objects
after a pause and links a real shared library with the host's C compiler,
and logs each step; two processes build into one temporary ``BUILD_DIR``
at once."""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent

STUB = """\
import os, subprocess, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
step = "link" if "-shared" in args else "compile"
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(step + "\\n")
time.sleep(0.5)
if step == "compile":
    with open(out, "w") as f:
        f.write("object\\n")
    print("ptxas info    : Used 32 registers")
    sys.exit(0)
objs = args[args.index("-o") + 2:]
missing = [o for o in objs if not os.path.exists(o)]
if missing:
    print("missing objects", missing)
    sys.exit(1)
src = out + ".c"
with open(src, "w") as f:
    f.write("int emcid_stub(void) { return 7; }\\n")
code = subprocess.run(["cc", "-shared", "-fPIC", "-o", out, src]).returncode
os.unlink(src)
sys.exit(code)
"""


def test_concurrent_builds_share_one_library(tmp_path):
    if shutil.which("cc") is None:
        pytest.fail("the stub's link step needs a C compiler (cc)")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + STUB)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "kernels"
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               CUDA_HOME=str(tmp_path / "no_cuda"), STUB_NVCC_LOG=str(log),
               PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    code = textwrap.dedent("""\
        import sys
        from pathlib import Path
        from emcid_torch.ops import _build
        _build.BUILD_DIR = Path(sys.argv[1])
        print(_build.build())
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.parent == build_dir and lib.name.startswith("libemcid_kernels_")
    assert ctypes.CDLL(str(lib)).emcid_stub() == 7
    # one process built (one nvcc per source, one link); the other waited
    # on the lock and found the library
    steps = log.read_text().split()
    assert steps.count("link") == 1
    from emcid_torch.ops import _build

    assert steps.count("compile") == len(_build.SOURCES)
    left = sorted(p.name for p in build_dir.iterdir())
    assert left == sorted([lib.name, ".lock", "ptxas.log"]), left
