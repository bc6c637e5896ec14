"""Pipeline orchestration: storage adapters, ingest, the stage runners,
run manifests, the surface task and the streaming session and servers.
The package's public names load with their modules on first access, so
``import iv_interpolation_tpu_torch.pipeline.manifest`` imports no torch."""

from iv_interpolation_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "MemoryStore": "iv_interpolation_tpu_torch.pipeline.storage",
    "ParquetStore": "iv_interpolation_tpu_torch.pipeline.storage",
    "get_store": "iv_interpolation_tpu_torch.pipeline.storage",
    "RunManifest": "iv_interpolation_tpu_torch.pipeline.manifest",
    "PipelineRunner": "iv_interpolation_tpu_torch.pipeline.runner",
})
