from repro_torch.models.model import LM, build_model
