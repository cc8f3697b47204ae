"""``kernels/build.py`` across processes, with a stub compiler: two
processes that find a library missing at once compile it once (the
build directory's lock), both then see it whole, and a failed compile
leaves no library behind."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STUB = """#!/bin/sh
# a stand-in for nvcc: count the run, take a second, write the -o file
echo run >> "{count}"
sleep 1
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
printf 'lib' > "$out"
echo "ptxas info    : Used 1 registers"
exit {rc}
"""
CHILD = ("import sys\nfrom pathlib import Path\n"
         "from repro_torch.kernels import build\n"
         "build.BUILD_DIR = Path(sys.argv[1])\n"
         "try:\n"
         "    print(sorted(build.build(['decode_attention'])))\n"
         "except RuntimeError as e:\n"
         "    print('failed', str(e).splitlines()[0])\n")


def _run_two(tmp_path, rc=0):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    count = tmp_path / "count"
    stub = bindir / "nvcc"
    stub.write_text(STUB.format(count=count, rc=rc))
    stub.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(out)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    said = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    runs = count.read_text().split() if count.exists() else []
    return sorted(said), len(runs), out


def test_two_processes_compile_a_missing_library_once(tmp_path):
    said, runs, out = _run_two(tmp_path)
    assert runs == 1
    assert said == ["['decode_attention']", "[]"]
    libs = sorted(out.glob("libdecode_attention-*.so"))
    assert len(libs) == 1 and libs[0].read_text() == "lib"
    assert libs[0].with_suffix(".ptxas.txt").exists()
    assert not list(out.glob("*.tmp.so"))


def test_a_failed_compile_leaves_no_library(tmp_path):
    said, runs, out = _run_two(tmp_path, rc=1)
    assert runs == 2            # the second process tries again
    assert all(s.startswith("failed kernel build failed") for s in said)
    assert not list(out.glob("*.so"))
