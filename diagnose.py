"""Layer-by-layer pipeline diagnostic (see letf_tpu/diagnose.py)."""
from letf_tpu.diagnose import diagnose_pipeline
from letf_tpu.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    diagnose_pipeline()
