"""Signature-k-mer annotation engine on PyTorch and CUDA.

The port of the JAX package ``kmergutsjava_tpu`` (which stays the reference
it is tested against) to one NVIDIA GPU: FASTA (proteins, or DNA through
6-frame translation) -> amino-acid 8-mer encoding -> signature-table lookup
through hand-written CUDA kernels (a sparse tile-join probe, a dense stream
probe) -> per-sequence function CALLs and OTU counts, bit-identical to the
reference's text report. Importing this package imports neither jax nor the
JAX package.
"""
__version__ = "0.1.0"

# Public library surface (lazy: importing the package stays cheap and
# imports no torch until a name that needs it is used).
_EXPORTS = {
    "Engine": ("kmergutsjava_tpu_torch.models.pipeline", "Engine"),
    "EngineConfig": ("kmergutsjava_tpu_torch.config", "EngineConfig"),
    "build_table": ("kmergutsjava_tpu_torch.formats.kmer_table",
                    "build_table"),
    "read_table": ("kmergutsjava_tpu_torch.formats.kmer_table", "read_table"),
    "write_table": ("kmergutsjava_tpu_torch.formats.kmer_table",
                    "write_table"),
    "KmerTable": ("kmergutsjava_tpu_torch.formats.kmer_table", "KmerTable"),
    "read_fasta": ("kmergutsjava_tpu_torch.formats.fasta", "read_fasta"),
    "FastaRecord": ("kmergutsjava_tpu_torch.formats.fasta", "FastaRecord"),
    "load_function_index": ("kmergutsjava_tpu_torch.formats.function_index",
                            "load_function_index"),
    "signatures_from_proteins": ("kmergutsjava_tpu_torch.formats.table_tools",
                                 "signatures_from_proteins"),
    "write_data_dir": ("kmergutsjava_tpu_torch.formats.table_tools",
                       "write_data_dir"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value  # cache for subsequent lookups
    return value
