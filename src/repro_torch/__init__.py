"""PyTorch + CUDA port of the SMLA system (reference: the ``repro``
package, JAX).  Module paths mirror the reference's, so
``repro_torch/core/smla/engine.py`` is held against
``repro/core/smla/engine.py``.  Nothing here imports JAX or the
reference package."""
