from .pipeline import ByteTokenizer, LMDataset, Prefetcher, synthetic_corpus

__all__ = ["ByteTokenizer", "LMDataset", "Prefetcher", "synthetic_corpus"]
