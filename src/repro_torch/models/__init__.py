"""Dense-family model: configs, layers and the transformer assembly."""
