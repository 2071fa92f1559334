"""Scorer models: self-attention, BiLSTM, AVScorer."""
