"""The native C ABI of the port: ``libmh_tpu_torch.so``.

The counterpart of ``mh_tpu/native/``: a C library exporting
``MHKernelWrapper`` / ``MHDeviceReport`` (the wire structs of ``wire.h``)
and the reference's ``KernelWrapper`` / ``KernelWrapperFree``
(``ref_compat.h``), which embeds CPython and runs
:func:`mh_tpu_torch.suggest_layouts` through :mod:`.bridge`; on the card
that is the fused CUDA kernel. It exports the same symbols as
``mh_tpu``'s ``libmh_tpu.so``, so a C or C# host links either unchanged
(and a process loads one of the two, never both).

- :mod:`.bridge` — the Python side: decode the wire structs, run, encode
- :mod:`._build` — ``g++`` builds the library and the C hosts at first use
- :mod:`.abi` — the library's entry points called from Python via ctypes

Environment: ``MH_TPU_TORCH_DEVICE`` picks the device (default the card;
the CPU only when named), ``MH_TPU_SEED`` seeds ``KernelWrapper`` (default
the wall clock), ``MH_TPU_PYROOT`` overrides the repo root the embedded
interpreter imports the port from.
"""
