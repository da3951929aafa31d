"""The plain reference that decides a run's ``correct``.

Plain PyTorch, frozen from ``mh_tpu_torch`` at commit 97f1de5 so that the
benchmark's yardstick stays put while the program changes. It imports
nothing of ``mh_tpu_torch``, ``mh_tpu`` or ``jax``: from the scene in a
configuration file and the integer keys of the calls it works out every
expected result itself. Each module names the port file it was copied from:

- ``counter_hash``: the fused kernel's counter-based uniforms
  (``kernels/counter_rng.py``, ``kernels/fused_mh.py`` ``uniform_block``);
- ``threefry``: the torch engine's ``jax.random`` threefry stream
  (``sampler/prng.py``: ``key``, ``fold_in``, ``uniform``);
- ``scene``: the scene tensors (``models/scene.py`` ``SceneSpec.build``);
- ``fused``: the fused chain's plain version (``kernels/fused_mh.py``
  ``pack_scene``, ``_Objective``, ``fused_chains_reference``);
- ``engine``: the torch chain engine's objective, step and replica
  exchange (``ops/costs.py``, ``ops/geometry.py``, ``sampler/proposal.py``,
  ``sampler/mh.py``, ``sampler/tempering.py``).

Every function takes a ``dtype``: float32 is the configuration's
precision, bfloat16 the control that a sound comparison must fail.
"""
