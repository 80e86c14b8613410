# tpuar build/test entry points (the reference's 42-line Makefile analog:
# the native libraries — the golden codec and the CPU and CUDA builds of
# the coder op — are auto-built on first use; these targets exist for
# explicit builds and CI-style runs).

PY ?= python

.PHONY: all native test bench clean

all: native

native:
	$(PY) -c "from gpuar_tpu import native; native.load(); native.coder_library('cpu'); print('golden codec and CPU coder op built')"

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

bench-table:
	$(PY) benchmarks/run.py

clean:
	rm -rf gpuar_tpu/native/_build __pycache__ */__pycache__ */*/__pycache__
