# kanter_core_tpu developer entry points
.PHONY: test smoke bench soak parity demo native clean

test:   ## the CPU suite (JAX_PLATFORMS=cpu is set by tests/conftest.py)
	python -m pytest tests/ -q

smoke:  ## the main path, kernels, parity and card-only tests on one GPU
	python chip_smoke.py

bench:  ## GPU benchmark (refuses to run without a GPU)
	python bench.py

soak:   ## randomized interactive edits vs compiled ground truth
	python scripts/soak.py 120 0

parity: ## f32-plane parity battery: this backend vs an XLA:CPU child process
	python -m kanter_core_tpu.parity

demo:   ## run all self-contained examples
	python examples/interactive_editing.py
	python examples/batch_sharded.py
	python examples/memory_tiering.py
	python examples/fit_texture.py

native: ## force-rebuild the C++ host kernels
	g++ -O3 -march=native -shared -fPIC -o native/_kanter_native.so native/kanter_native.cpp

clean:
	rm -rf native/_kanter_native.so **/__pycache__ .pytest_cache
