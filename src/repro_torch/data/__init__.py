from repro_torch.data.synthetic import (  # noqa: F401
    batch_iterator,
    lm_batch_iterator,
    make_image_dataset,
    make_lm_dataset,
)
