# Build/test entry points (reference Makefile:3-18 had fmt+vet+build; this
# framework is Python so "local" = lint-ish checks + tests).
PY ?= python3
IMAGE ?= yoda-tpu-scheduler
TAG ?= 0.1.0

.PHONY: local test bench simulate graft build push clean native

local: native test

native: native/libyodaplace.so

native/libyodaplace.so: native/placement.cc native/fusedplane.cc native/commitplane.cc native/carveplane.cc native/eventplane.cc
	g++ -O2 -std=c++17 -shared -fPIC -o $@ $^

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q --ignore=tests/test_models_parallel.py --ignore=tests/test_ops.py

bench:
	$(PY) bench.py

simulate:
	$(PY) -m yoda_scheduler_tpu.cli simulate example/test-pod.yaml \
		example/test-deployment.yaml example/resnet-v4-8.yaml \
		example/llama-v4-32-gang.yaml
	$(PY) -m yoda_scheduler_tpu.cli simulate example/llama-multislice-gang.yaml \
		--tpu-slices 2 --tpu-nodes 0 --gpu-nodes 0
	$(PY) -m yoda_scheduler_tpu.cli simulate example/mixtral-v5e-64.yaml \
		--tpu-slices 0 --v5e-slices 2 --tpu-nodes 0 --gpu-nodes 0

graft:
	$(PY) __graft_entry__.py

build:
	docker build -t $(IMAGE):$(TAG) .

push: build
	docker push $(IMAGE):$(TAG)

# the PyTorch/CUDA port's image (yoda_scheduler_tpu_torch/deploy/Dockerfile),
# the one every manifest of the port names
.PHONY: build-gpu
build-gpu:
	docker build -f yoda_scheduler_tpu_torch/deploy/Dockerfile -t yoda-gpu-scheduler:$(TAG) .

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
