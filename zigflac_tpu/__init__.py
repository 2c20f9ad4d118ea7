"""zigflac_tpu — an accelerator-native FLAC encoding framework in JAX.

A from-scratch re-design of the capabilities of the ``toastori/zig-flac``
reference encoder (wav2flac CLI + libFLAC module) for a JAX accelerator
(an NVIDIA GPU; the CPU backend runs the same programs for tests):

* Frames are the batch axis: all per-frame hot loops — stereo-mode selection,
  fixed-predictor order search, residual computation, Rice parameter sweep —
  run as batched JAX/XLA integer tensor ops over a device-resident
  ``[n_frames, block_size]`` sample tensor (reference hot loops:
  libFLAC/fixed.zig:88-168, libFLAC/rice.zig:237-375,
  libFLAC/Encoder.zig:233-376).
* Bitstream assembly is parallelized: per-symbol bit lengths -> prefix-sum bit
  offsets -> segment-sum bit deposits into packed words on device (reference
  serial bit packer: libFLAC/FrameWriter.zig:36-114).
* CRC-16 runs as an on-device GF(2)-linear reduction (reference serial/clmul
  path: libFLAC/Crc16.zig).
* The serial WAV parse stays on host as a thin feeder
  (reference: src/WavReader.zig).

Public API mirrors the reference's ``libFLAC`` module surface:
``Encoder``, ``EncoderConfig``, ``StreamInfo``, plus the ``wav2flac``
CLI (``python -m zigflac_tpu.cli``).
"""

import os as _os

import jax as _jax

# The 32-bit-depth side channel is 33-bit signed (libFLAC/Encoder.zig:50,95-100)
# and the Rice cost sweep uses u64 wrapping arithmetic (libFLAC/rice.zig:344-375);
# both need x64 mode. Hot kernels stay in 32-bit dtypes explicitly.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (JAX
# reads that variable itself), else a fixed directory in the checkout. The
# path is part of the cache's identity, so it never depends on a temporary
# name, a process id or the time.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
_jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .metadata import StreamInfo, BlockType  # noqa: E402
from .utils.config import EncoderConfig  # noqa: E402
from .wav import WavReader, WavStreamReader, WavFormatError  # noqa: E402
from .models.encoder import (  # noqa: E402
    Encoder,
    encode_wav_bytes,
    encode_wav_bytes_many,
    encode_file,
    encode_file_streaming,
    encode_to_file,
)
from .decoder import (  # noqa: E402
    decode_file,
    decode_flac,
    decode_range,
    verify_flac,
)

__version__ = "0.1.0"

__all__ = [
    "StreamInfo",
    "BlockType",
    "EncoderConfig",
    "WavReader",
    "WavStreamReader",
    "WavFormatError",
    "Encoder",
    "encode_wav_bytes",
    "encode_wav_bytes_many",
    "encode_file",
    "encode_file_streaming",
    "encode_to_file",
    "decode_file",
    "decode_flac",
    "decode_range",
    "verify_flac",
    "__version__",
]
