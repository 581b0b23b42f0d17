# Developer entry points (CI runs the same targets).

.PHONY: check test lint native golden

check: lint test

test:
	python -m pytest tests/ -q

lint:
	@if python -c "import ruff" 2>/dev/null || command -v ruff >/dev/null; then \
	  ruff check lexls_tpu tests tools bench.py bench_extra.py __graft_entry__.py \
	    lexls_tpu_torch bench_torch.py bench_extra_torch.py chip_smoke.py; \
	else \
	  echo "ruff unavailable — falling back to a syntax check"; \
	  python -m compileall -q lexls_tpu tests tools bench.py bench_extra.py __graft_entry__.py \
	    lexls_tpu_torch bench_torch.py bench_extra_torch.py chip_smoke.py; \
	fi

native:
	$(MAKE) -C native

# regenerate reference golden fixtures (needs the read-only reference
# checkout and Eigen headers; see tools/golden/generate.py)
golden:
	python tools/golden/generate.py
