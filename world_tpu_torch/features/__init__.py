"""Feature codecs (mel filterbanks, MCEP, context windows) and the VAE MLP."""
