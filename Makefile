# Developer entry points. Tests run on the CPU (JAX_PLATFORMS defaults to cpu
# in tests/conftest.py, with a virtual 8-device mesh). The GPU targets need a
# CUDA GPU (nvcc under $CUDA_HOME or /usr/local/cuda builds the kernel).

.PHONY: test test-quick test-gpu native smoke smoke-four bench bench-xla bench-iekf matrix parity artifacts consistency demo dryrun clean

test:
	python -m pytest tests/ -q

test-quick:     ## edit-loop tier: skips @pytest.mark.slow (<~3 min on CPU)
	python -m pytest tests/ -q -m "not slow"

test-gpu:       ## the CUDA kernel's tests (GPU)
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu

native:
	$(MAKE) -C native

smoke:          ## start-up check of the main path on one GPU
	python chip_smoke.py

smoke-four:     ## the world-parallel path on four GPUs
	python chip_smoke.py --four-cards

bench:          ## headline EKF benchmark, CUDA kernel (GPU; one JSON line)
	python bench.py

bench-xla:      ## the models/ vmap(scan) path (GPU)
	BENCH_IMPL=xla python bench.py

bench-iekf:
	BENCH_FILTER=iekf_slam python bench.py

matrix:         ## full accuracy matrix (GPU; resumes from the output file)
	python scripts/accuracy_matrix.py --out docs/accuracy_matrix_v2.json

parity:         ## published-magnitude parity vs the reference CSVs (GPU; resume-safe)
	python scripts/reference_parity.py --out docs/reference_parity.json
	python scripts/parity_report.py

artifacts:      ## reference-layout data/ + plots/ trees (calibrated + honest; CPU)
	JAX_PLATFORMS=cpu MPLBACKEND=Agg python scripts/matrix_to_artifacts.py \
		--matrix docs/reference_parity.json docs/reference_parity_w5x.json
	JAX_PLATFORMS=cpu MPLBACKEND=Agg python scripts/matrix_to_artifacts.py \
		--matrix docs/accuracy_matrix_v2.json \
		--data-dir data/honest_mode \
		--plots-dir plots/err_comparisons_honest_mode

consistency:    ## NEES comparison EKF vs RI-EKF (CPU-friendly)
	JAX_PLATFORMS=cpu python scripts/consistency.py

demo:           ## headless filter demo (CPU)
	JAX_PLATFORMS=cpu MPLBACKEND=Agg python -m live_ekf_slam_tpu.cli \
		filter_demo_results_only --filter ekf_slam --steps 200

dryrun:         ## multi-device sharding dryrun on a virtual CPU mesh
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
		python -c "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"

clean:
	$(MAKE) -C native clean
