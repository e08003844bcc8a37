#!/usr/bin/env bash
# Device-tensor ping-pong (ompi_tpu_torch/examples/p2p_bandwidth.py, 2
# ranks on one card) with the progress engine's default idle policy and
# with a spin that never yields (yield_when_idle off, a huge
# progress_spin_count), in turns: default, spin, spin, default. Prints
# one line per size (bytes, chunk bytes, one-way ms, one-way GB/s,
# bitwise ok) and the host ping-pong's one-way GB/s per size.
#   bash scripts/p2p_spin_ab.sh   (from the repo root, on a card)
set -e
L="python -m ompi_tpu_torch.runtime.launcher -n 2 --timeout 300"
P="ompi_tpu_torch/examples/p2p_bandwidth.py --sizes 4m,64m,256m --whole-sizes 256m --iters 10"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for turn in default spin spin default; do
  if [ "$turn" = spin ]; then
    M="--mca yield_when_idle off --mca progress_spin_count 100000000"
  else
    M=""
  fi
  echo "TURN $turn"
  $L $M $P | python -c "
import json, sys
d = json.loads(sys.stdin.read().splitlines()[-1])
for c in d['pingpong']:
    print(c['bytes'], c['chunk_bytes'], round(c['oneway_ms'], 3),
          round(c['oneway_gbps'], 3), c['ok'])
for c in d['stages']:
    print('stage', c['bytes'], round(c['host_oneway_gbps'], 3))"
done
