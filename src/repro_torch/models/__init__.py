"""Model families: the decoder LM (dense and MoE), the GNNs, and the recommender."""
