from csl_gan_tpu_torch.data.loader import ArrayDataset, Loader, init_data, n_batches
