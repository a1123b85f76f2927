"""seaweedfs_tpu_torch: the PyTorch/CUDA port of seaweedfs_tpu.

An EC cluster on an NVIDIA card: needle volumes, RS(10,4) encode into
`.ec00`..`.ec13` + `.ecx` + `.eci`, shard rebuild and degraded needle
reads, with every GF(2^8) product in the hand-written kernel
csrc/gf_matmul.cu; the volume server over HTTP, the master (assign,
lookup, heartbeats, growth, the admin lease), the client and the shell's
EC commands; security.toml's tokens, whitelist and mTLS (security/), and
mapped and tiered volumes (storage/backend.py).  Files are byte-identical to seaweedfs_tpu's.  Entry points
take ``device`` ("cuda" by default; "cpu" runs the plain PyTorch
versions).  The package imports torch and numpy, never jax and nothing
of seaweedfs_tpu.
"""
