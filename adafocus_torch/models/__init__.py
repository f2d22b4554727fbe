"""Model modules: backbones, recurrent heads, policy and the GFV composition."""
