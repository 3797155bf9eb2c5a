# Developer entry points.  Tests force the CPU platform (8-device virtual
# mesh); bench runs on whatever device the session exposes.

PY ?= python

.PHONY: test test-fast bench native cabi cabi-torch clean

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -k "not fuzz"

bench:
	$(PY) bench.py

native:
	rm -f matchtigs_tpu/native/_native.so
	$(PY) -c "from matchtigs_tpu import native; native.load(); print('native build ok')"

# Embeddable C ABI (reference clib.rs equivalent) for non-Python hosts
cabi:
	gcc -shared -fPIC -O2 native/capi_embed.c \
	  $$(python3-config --includes) -o libmatchtigs_tpu.so \
	  $$(python3-config --ldflags --embed)

# The port's C ABI: the same surface over matchtigs_tpu_torch.capi
cabi-torch:
	$(PY) -c "from matchtigs_tpu_torch import native; native.build_capi('libmatchtigs_tpu_torch.so')"

clean:
	rm -rf matchtigs_tpu/native/_native.so .jax_cache .bench_data \
	  $$(find . -name __pycache__ -type d)
