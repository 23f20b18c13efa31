from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM, TokenFile, batch_at_step
