"""Messages of sidecar.proto, built in a descriptor pool of their own.

The wire is the JAX package's (tieredstorage_tpu/sidecar/sidecar_pb2.py):
package ``tieredstorage.sidecar.v1``, the same messages and field numbers.
That module registers its file in protobuf's default pool, where a second
file defining the same symbols is refused ("duplicate symbol"), and a
process may import both packages. So this file's descriptor (protoc's
serialized FileDescriptorProto of sidecar.proto, named after this package's
path) goes into a private ``DescriptorPool`` and the message classes are
made from it: both modules import in one process, in either order, and
their messages serialize to the same bytes.
"""

from google.protobuf import descriptor_pool, message_factory

_POOL = descriptor_pool.DescriptorPool()

DESCRIPTOR = _POOL.AddSerializedFile(b'\n-tieredstorage_tpu_torch/sidecar/sidecar.proto\x12\x18tieredstorage.sidecar.v1"S\n\tSegmentId\x12\x10\n\x08topic_id\x18\x01 \x01(\x0c\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x12\n\nsegment_id\x18\x04 \x01(\x0c"\x90\x03\n\x0fSegmentMetadata\x12/\n\x02id\x18\x01 \x01(\x0b2#.tieredstorage.sidecar.v1.SegmentId\x12\x14\n\x0cstart_offset\x18\x02 \x01(\x03\x12\x12\n\nend_offset\x18\x03 \x01(\x03\x12\x18\n\x10max_timestamp_ms\x18\x04 \x01(\x03\x12\x11\n\tbroker_id\x18\x05 \x01(\x05\x12\x1a\n\x12event_timestamp_ms\x18\x06 \x01(\x03\x12R\n\rleader_epochs\x18\x07 \x03(\x0b2;.tieredstorage.sidecar.v1.SegmentMetadata.LeaderEpochsEntry\x12\x1a\n\x12segment_size_bytes\x18\x08 \x01(\x03\x12\x17\n\x0fcustom_metadata\x18\t \x01(\x0c\x12\x1b\n\x13has_custom_metadata\x18\n \x01(\x08\x1a3\n\x11LeaderEpochsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\r\n\x05value\x18\x02 \x01(\x03:\x028\x01"\xfa\x01\n\x0bCopyRequest\x12;\n\x08metadata\x18\x01 \x01(\x0b2).tieredstorage.sidecar.v1.SegmentMetadata\x12\x13\n\x0blog_segment\x18\x02 \x01(\x0c\x12\x14\n\x0coffset_index\x18\x03 \x01(\x0c\x12\x12\n\ntime_index\x18\x04 \x01(\x0c\x12\x19\n\x11producer_snapshot\x18\x05 \x01(\x0c\x12\x19\n\x11transaction_index\x18\x06 \x01(\x0c\x12\x1d\n\x15has_transaction_index\x18\x07 \x01(\x08\x12\x1a\n\x12leader_epoch_index\x18\x08 \x01(\x0c"\'\n\x0cCopyResponse\x12\x17\n\x0fcustom_metadata\x18\x01 \x01(\x0c"\x8a\x01\n\x0cFetchRequest\x12;\n\x08metadata\x18\x01 \x01(\x0b2).tieredstorage.sidecar.v1.SegmentMetadata\x12\x16\n\x0estart_position\x18\x02 \x01(\x03\x12\x14\n\x0cend_position\x18\x03 \x01(\x03\x12\x0f\n\x07has_end\x18\x04 \x01(\x08"d\n\x11FetchIndexRequest\x12;\n\x08metadata\x18\x01 \x01(\x0b2).tieredstorage.sidecar.v1.SegmentMetadata\x12\x12\n\nindex_type\x18\x02 \x01(\t"\x1a\n\nFetchChunk\x12\x0c\n\x04data\x18\x01 \x01(\x0c"L\n\rDeleteRequest\x12;\n\x08metadata\x18\x01 \x01(\x0b2).tieredstorage.sidecar.v1.SegmentMetadata"\x07\n\x05Empty2\xc9\x03\n\x14RemoteStorageSidecar\x12U\n\x04Copy\x12%.tieredstorage.sidecar.v1.CopyRequest\x1a&.tieredstorage.sidecar.v1.CopyResponse\x12W\n\x05Fetch\x12&.tieredstorage.sidecar.v1.FetchRequest\x1a$.tieredstorage.sidecar.v1.FetchChunk0\x01\x12a\n\nFetchIndex\x12+.tieredstorage.sidecar.v1.FetchIndexRequest\x1a$.tieredstorage.sidecar.v1.FetchChunk0\x01\x12R\n\x06Delete\x12\'.tieredstorage.sidecar.v1.DeleteRequest\x1a\x1f.tieredstorage.sidecar.v1.Empty\x12J\n\x06Health\x12\x1f.tieredstorage.sidecar.v1.Empty\x1a\x1f.tieredstorage.sidecar.v1.Emptyb\x06proto3')



_MESSAGES = DESCRIPTOR.message_types_by_name

SegmentId = message_factory.GetMessageClass(_MESSAGES["SegmentId"])
SegmentMetadata = message_factory.GetMessageClass(_MESSAGES["SegmentMetadata"])
CopyRequest = message_factory.GetMessageClass(_MESSAGES["CopyRequest"])
CopyResponse = message_factory.GetMessageClass(_MESSAGES["CopyResponse"])
FetchRequest = message_factory.GetMessageClass(_MESSAGES["FetchRequest"])
FetchIndexRequest = message_factory.GetMessageClass(_MESSAGES["FetchIndexRequest"])
FetchChunk = message_factory.GetMessageClass(_MESSAGES["FetchChunk"])
DeleteRequest = message_factory.GetMessageClass(_MESSAGES["DeleteRequest"])
Empty = message_factory.GetMessageClass(_MESSAGES["Empty"])
