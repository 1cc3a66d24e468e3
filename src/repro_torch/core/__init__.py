"""GEAR core: KV-cache compression (quant backbone + low-rank + sparse)."""
