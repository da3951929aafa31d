"""Runnable examples of the port, the counterparts of ``examples/*.py``.

    python -m mh_tpu_torch.examples.demo_layout [--chains N] [--iters N] [--objects N]
    python -m mh_tpu_torch.examples.huge_scene [--objects 2048] [--objs-devices 4]
    python -m mh_tpu_torch.examples.advanced_sampling [--objects 16] [--replicas 16]

Each takes the JAX example's flags plus ``--device`` (default: the card;
without one it raises, and the CPU runs only when named).
"""
