from repro_torch.data.synthetic import lm_batch_iterator, make_lm_dataset  # noqa: F401
