"""The benchmark of ``isoforest_tpu_torch`` on one H100: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

``reference/`` is the yardstick (inputs from the seed, the plain scorer,
the work the roofline counts, the card's peaks) and imports nothing of the
port; the harness's other modules drive the port, the system under test.
Nothing here imports JAX or the JAX package.
"""
