#!/usr/bin/env bash
# One-command precommit, mirroring the reference's `just precommit`
# (fmt + clippy + test, /root/reference/Justfile:1-8). No Python
# linter is baked into this image, so the lint stage is a strict
# byte-compile pass over the package + tests + scripts; the test stage
# is the full suite on the 8-device virtual CPU mesh.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== lint (byte-compile, strict) =="
python -m compileall -q -f grav1synth tests scripts bench.py __graft_entry__.py

echo "== native shim build =="
make -C grav1synth/container/native -s

echo "== tests =="
python -m pytest tests/ -q "$@"
