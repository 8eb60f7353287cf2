# Reproducible runtime environment — the rebuild of the reference's Docker
# setup (its ROS-Noetic image building qhull/ceres/iridescence from source).
# This engine needs only Python + JAX (+ a C++ toolchain for the native host-IO
# codec); for an NVIDIA GPU install JAX with its CUDA plugin (jax[cuda12]).

FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY pointcloudprocessor_tpu ./pointcloudprocessor_tpu
COPY native ./native
COPY run_pcd_colorization.sh bench.py ./

# CPU JAX by default; on a host with an NVIDIA GPU use the CUDA plugin:
#   pip install 'jax[cuda12]'
RUN pip install --no-cache-dir "jax[cpu]" numpy opencv-python-headless matplotlib scipy \
    && pip install --no-cache-dir -e . \
    && make -C native

ENTRYPOINT ["python", "-m", "pointcloudprocessor_tpu.cli"]
