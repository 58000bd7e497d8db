"""State layer: the zktrie (sparse Poseidon Merkle trie), a host copy."""

from zkevm_tpu_torch.state.zktrie import ZkTrie

__all__ = ["ZkTrie"]
