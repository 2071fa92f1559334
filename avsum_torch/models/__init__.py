"""Scorer models: self- and cross-attention, the temporal encoders (BiLSTM,
attention, staged attention, TCN, MoE, the Moonlight decoder) and
AVScorer."""
