"""The serving benchmark of the PyTorch and CUDA port (``repro_torch``).

One cell is one entry of ``BENCHMARK.json``'s ``workloads``: a model
configuration (``configs/<config>.json``) under a traffic mix
(``traffic/<mix>.json``, whose ``loop`` names a generator module under
``loops/``). ``run.py`` runs one cell once; per-layer metrics are read by
``metrics/<metric>.py``, and kernel work by ``kernels/<kernel>.py``. A
configuration's model module (``reference/<name>.py``, ``model`` unless
the configuration names another) holds the plain float32 reference that
decides ``correct`` and what else the harness reads of the model's
equations: its weight draws, FLOPs and attention layers.

Nothing here imports JAX or the JAX package; only ``program.py`` and
``run.py`` import ``repro_torch``, and ``reference/`` never does.
"""
