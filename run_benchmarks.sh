#!/bin/bash
# Benchmark driver (the analog of run_poseidon_benchmark.sh /
# run_merkle_benchmarks.sh): quick / full / per-layer / verification modes.
set -e
MODE="${1:-quick}"
case "$MODE" in
  quick)    python bench.py ;;
  full)     python -m cuzk_tpu.bench.run --suite all ;;
  poseidon) python -m cuzk_tpu.bench.run --suite poseidon ;;
  merkle)   python -m cuzk_tpu.bench.run --suite merkle
            python -m cuzk_tpu.bench.run --suite proofs ;;
  resident) python -m cuzk_tpu.bench.run --suite proofs --device-resident ;;
  # CPU-only rehearsal of the multi-host protocol (never on a GPU).
  mp-scaling) python -m cuzk_tpu.bench.mp_scaling --leaves-per-device \
            "${LEAVES_PER_DEVICE:-512}" --arity 8 --procs 1 2 4 ;;
  compare)  python -m cuzk_tpu.bench.run --suite compare ;;
  sweep)    python -m cuzk_tpu.bench.run --suite sweep ;;
  smoke)    python chip_smoke.py ;;
  scaling)  python -m cuzk_tpu.bench.run --suite scaling --weak --arity 8 \
                --leaves "${LEAVES_PER_DEVICE:-4096}" ;;
  *) echo "usage: $0 [quick|full|poseidon|merkle|compare|sweep|smoke|scaling|resident|mp-scaling]"
     exit 1 ;;
esac
