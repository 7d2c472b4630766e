from emr2a_tpu_torch.data.manifest import load_manifest, save_manifest

__all__ = ["load_manifest", "save_manifest"]
