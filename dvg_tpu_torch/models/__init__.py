"""Model pieces of the port: layers, the DCGAN and VGG backbones at 64 and
128 px and their registry, the latent predictors (lstm; gru, rnn and
gaussian_lstm), VGG's Gaussian encoder, the SVGP, and the classifiers."""
