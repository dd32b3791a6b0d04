"""The benchmark of ``water_sandbox_tpu_torch`` on one card.

``python3 -m sphbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Each cell's configuration, traffic, limits and metrics are files found
by name (``cell.py``); one generator drives every traffic mix
(``drive.py``); the check holds what the timed path produced against the
plain reference (``check.py``, ``reference/``); ``calibrate.py`` reads the
numbers its limits are set from. Nothing here imports JAX or the JAX
package.
"""
