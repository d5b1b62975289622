# Convenience targets (the analog of the reference's Makefile wrapper).
PYTHON ?= python

.PHONY: test test-fast test-gpu test-stress bench smoke profile native clean

test:
	$(PYTHON) -m pytest tests/ -q

test-fast:
	$(PYTHON) -m pytest tests/test_oracle.py tests/test_utils.py tests/test_native.py -q

# The gpu-marked tests, on a machine with a GPU: one process, since each
# JAX process reserves most of the card's memory.
test-gpu:
	CUZK_TEST_GPU=1 $(PYTHON) -m pytest tests/ -q -m gpu -n 0

# Stress tier (64K+-leaf trees) — the analog of the reference's
# DISABLED_StressTestLargeTree, opt-in like its DISABLED_ prefix.
test-stress:
	CUZK_STRESS=1 $(PYTHON) -m pytest tests/test_stress.py -q

bench:
	$(PYTHON) bench.py

smoke:
	$(PYTHON) chip_smoke.py

bench-all:
	$(PYTHON) -m cuzk_tpu.bench.run --suite all

profile:
	$(PYTHON) -m cuzk_tpu.bench.profile --comprehensive

native:
	$(PYTHON) -c "from cuzk_tpu import native; print(native.ensure_built(force=True))"

clean:
	rm -rf cuzk_tpu/native/_build .pytest_cache .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
