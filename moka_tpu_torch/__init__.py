"""PyTorch/CUDA port of ``moka_tpu`` for one NVIDIA H100.

``moka_tpu_torch/<sub>/<file>.py`` ports ``moka_tpu/<sub>/<file>.py`` and
keeps its parameter layout (layer-stacked dicts, ``(d_in, d_out)``
matrices), so a JAX tree converts through numpy with no renaming
(``convert.params_from_numpy``).  The package imports torch and numpy only.
Hand-written Hopper kernels live in ``kernels/`` and are built on first use.
"""
