from repro_torch.data.blobs import make_blobs

__all__ = ["make_blobs"]
