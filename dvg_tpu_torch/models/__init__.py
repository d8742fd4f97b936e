"""Model pieces of the port: layers, the DCGAN and VGG backbones at 64 and
128 px and their registry, the LSTM predictor, the SVGP."""
