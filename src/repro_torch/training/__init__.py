"""PEFT training of the port: AdamW, the data pipeline, layer units."""
