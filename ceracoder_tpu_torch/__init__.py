"""ceracoder_tpu_torch — the PyTorch/CUDA port of ceracoder_tpu.

A second package beside the JAX one, ported slice by slice and held
against it (equal arrays, byte-identical bitstreams). It imports torch
and numpy only: never jax, never anything of ``ceracoder_tpu``.

- ``codec/``   H.264 syntax, host CAVLC (exact fallback), the device
               CAVLC bit-packer and the ``H264Encoder`` (CAVLC only);
               HEVC syntax, the native entropy binding and the
               ``H265DeviceEncoder`` (IDR + low-delay P run path).
- ``ops/``     device compute: H.264 transforms, intra, inter,
               deblocking, and the window merge (``ops/bitpack.py``)
               whose CUDA kernel lives in ``csrc/merge_windows.cu``;
               the HEVC row-slice compute (``ops/h265.py``).
- ``app/``     the live encoder app (``python -m ceracoder_tpu_torch``,
               HEVC): CLI, jobspec, host and device sources, overlay,
               PTS fixup and the main loop.
- ``control/`` the balancers, their runner (native core by default),
               QP rate control and the scene-cut detector.
- ``transport/`` MPEG-TS mux, the 1316 B packer, the SRT client and the
               bonded-link emulator (``linksim.py``).
- ``audio/``   AAC / Opus encoding through the native shim.
- ``native/``  ctypes declarations of the native balancer and buffers,
               and the native TS muxer, packer and SRT client.
- ``bindings/`` the supervisor's API: argv, job and config writers,
               spawn, SIGHUP reload, SIGTERM stop of this package's app.
- ``utils/``   device resolution, the kernel build and the native
               libraries' build.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
