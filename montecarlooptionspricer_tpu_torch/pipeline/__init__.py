"""The PredictionGen pipeline: option CSV in, augmented CSV out."""
