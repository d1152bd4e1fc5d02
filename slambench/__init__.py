"""The benchmark of rgbdslam_tpu_torch: full RGB-D SLAM on one CUDA card.

`python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Configurations
(`configs/`), traffic mixes (`traffic/`), per-cell limits (`limits/`) and
metrics (`metrics/`) are files found by the names the manifest gives them.
Nothing here imports JAX or the JAX package; `reference/` imports nothing of
the program either.
"""
