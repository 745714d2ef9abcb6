"""Single-path TQQQ return decomposition (see letf_tpu/diagnose.py)."""
from letf_tpu.diagnose import diagnose_tqqq_detailed
from letf_tpu.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    diagnose_tqqq_detailed()
