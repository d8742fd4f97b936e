"""Model pieces of the port: layers, DCGAN-64, the LSTM predictor, the SVGP."""
