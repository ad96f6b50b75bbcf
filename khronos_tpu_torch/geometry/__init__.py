from khronos_tpu_torch.geometry.camera import Camera

__all__ = ["Camera"]
