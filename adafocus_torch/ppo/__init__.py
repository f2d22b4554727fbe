"""PPO for the patch policy (counterpart of adafocus_tpu/ppo)."""
