"""The platform operator (``up -f cr.yaml``) and its k8s manifests."""
