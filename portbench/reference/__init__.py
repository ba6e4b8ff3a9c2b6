"""The benchmark's yardstick: seeded data generators (:mod:`.data`), the
forest growers (:mod:`.forest`), the plain scorer with its visited-node and
byte counts (:mod:`.score`) and the peaks of the card (:mod:`.peaks`).

Nothing here imports the port, the JAX package or JAX: the reference works
every path length out again from the arrays the benchmark made.
"""
