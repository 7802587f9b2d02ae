from .hmm_artifacts import build_hmm_artifacts, load_hmm_artifacts

__all__ = ["build_hmm_artifacts", "load_hmm_artifacts"]
