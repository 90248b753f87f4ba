from csl_gan_tpu_torch.data.loader import ArrayDataset, init_data, n_batches
