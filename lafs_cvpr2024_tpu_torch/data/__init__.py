"""The SSL input path without jax or PIL: RecordIO, the dataset of JPEG
bytes, the card's JPEG decoder and the epoch sampler and prefetcher."""
